"""The port's numeric context equals the reference package's, bit for bit,
including what convert.py carries across."""

import dataclasses

import numpy as np
import pytest
import torch

from gatk_hc_tpu import config as jax_config
from gatk_hc_tpu.ops import pairhmm_jax, pairhmm_pallas
from gatk_hc_tpu.utils import quality as jax_quality
from gatk_hc_tpu_torch import config as torch_config
from gatk_hc_tpu_torch import convert
from gatk_hc_tpu_torch.ops import pairhmm_torch
from gatk_hc_tpu_torch.utils import quality as torch_quality

QUALITY_NAMES = [
    name
    for name, value in vars(jax_quality).items()
    if name.isupper() and isinstance(value, (np.ndarray, np.generic, int, float))
]


def _bits(a):
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8) if a.dtype.kind == "f" else a


@pytest.mark.parametrize("name", QUALITY_NAMES)
def test_quality_tables_bitwise(name):
    ref = getattr(jax_quality, name)
    got = getattr(torch_quality, name)
    assert np.asarray(got).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize(
    "gop,gcp", [(ord("I"), ord("+")), (ord("5"), ord("*")), (40, 10)]
)
def test_transition_constants_bitwise(gop, gcp):
    ref = np.array(pairhmm_jax.transition_constants(gop, gcp), np.float32)
    got = np.array(pairhmm_torch.transition_constants(gop, gcp), np.float32)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_plane_tables_bitwise():
    args = (jax_quality.BASE_TABLE, jax_quality.PH2PR_F32)
    for ref, got in zip(
        pairhmm_pallas.plane_tables(*args), pairhmm_torch.plane_tables(*args)
    ):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        pairhmm_torch.ppe_element_table(*args),
        pairhmm_pallas.ppe_element_table(*args),
    )


def _reference_arrays():
    mask, omq, q3 = pairhmm_pallas.plane_tables(
        jax_quality.BASE_TABLE, jax_quality.PH2PR_F32
    )
    return {
        "PH2PR_F32": jax_quality.PH2PR_F32,
        "BASE_TABLE": jax_quality.BASE_TABLE,
        "mask": mask, "omq_bits": omq, "q3_bits": q3,
        "trans": np.array(
            pairhmm_jax.transition_constants(ord("I"), ord("+")), np.float32
        ),
    }


def test_tables_from_reference_equal_port_tables():
    got = convert.tables_from_reference(_reference_arrays(), "cpu")
    own = pairhmm_torch.make_tables(torch_config.DEFAULT_CONFIG, "cpu")
    assert set(got) == set(own)
    for key in own:
        assert got[key].dtype == own[key].dtype, key
        assert torch.equal(got[key], own[key]), key


def test_tables_from_reference_drive_runner_identically():
    """A runner built on the carried-across tables computes the same
    likelihoods as one built on the port's own."""
    import random

    from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
    from tests.test_pairhmm import make_pair, to_bytes

    rng = random.Random(7)
    reads, haps = [], []
    for _ in range(3):
        read, quals, hap = make_pair(rng, rng.randint(10, 30), 60, 1)
        reads.append((to_bytes(read), to_bytes(quals)))
        haps.append(to_bytes(hap))
    cfg = torch_config.DEFAULT_CONFIG
    results = []
    for tables in (None, convert.tables_from_reference(_reference_arrays(), "cpu")):
        job = PairHMMJob(reads, haps)
        TorchPairHMMRunner(cfg, device="cpu", tables=tables).run([job])
        results.append(job.result)
    np.testing.assert_array_equal(results[0], results[1])


def test_tables_from_reference_rejects_mismatch():
    arrays = _reference_arrays()
    arrays["omq_bits"] = arrays["omq_bits"].copy()
    arrays["omq_bits"][40] += 1
    with pytest.raises(ValueError, match="omq_bits"):
        convert.tables_from_reference(arrays, "cpu")
    with pytest.raises(ValueError, match="expected keys"):
        convert.tables_from_reference({"PH2PR_F32": arrays["PH2PR_F32"]}, "cpu")


def test_config_from_reference_default():
    d = dataclasses.asdict(jax_config.DEFAULT_CONFIG)
    got = convert.config_from_reference(d)
    assert got == torch_config.DEFAULT_CONFIG
    assert got.pairhmm_engine == "cuda"
    assert set(convert.TPU_ONLY_KEYS) <= set(d)
    assert not set(convert.TPU_ONLY_KEYS) & {
        f.name for f in dataclasses.fields(torch_config.HCConfig)
    }


def test_config_from_reference_carries_dispatch_keys():
    """The reference's dispatch settings cross unchanged (only pair_batch,
    the TPU tile width, is dropped)."""
    ref = dataclasses.replace(
        jax_config.DEFAULT_CONFIG, dispatch_mode="packed", packed_nib=False,
        fuse_groups=8, fuse_auto=False, device_timeout_s=30.0, pair_batch=256,
    )
    got = convert.config_from_reference(dataclasses.asdict(ref))
    assert (got.dispatch_mode, got.packed_nib, got.fuse_groups,
            got.fuse_auto, got.device_timeout_s) == ("packed", False, 8,
                                                     False, 30.0)
    assert convert.TPU_ONLY_KEYS == ("pair_batch",)
    default = convert.config_from_reference(
        dataclasses.asdict(jax_config.DEFAULT_CONFIG))
    for key in ("dispatch_mode", "packed_nib", "fuse_groups", "fuse_auto",
                "device_timeout_s"):
        assert getattr(default, key) == getattr(jax_config.DEFAULT_CONFIG, key)


def test_config_from_reference_carries_values():
    """Ported settings cross unchanged, the kernel selection included:
    pallas_algo and stripe_height are carried, not dropped."""
    ref = dataclasses.replace(
        jax_config.DEFAULT_CONFIG, pairhmm_engine="native", ppe_rows=8,
        region_size=300, read_pad_buckets=(64, 128), stripe_height=16,
        pallas_algo="striped", sw_params=jax_config.STANDARD_NGS_SW,
    )
    got = convert.config_from_reference(dataclasses.asdict(ref))
    assert (got.pairhmm_engine, got.ppe_rows, got.region_size) == ("native", 8, 300)
    assert (got.pallas_algo, got.stripe_height) == ("striped", 16)
    assert got.read_pad_buckets == (64, 128)
    assert got.sw_params == torch_config.STANDARD_NGS_SW
    # and back: every field the two configs share survives a round trip
    back = dataclasses.asdict(got)
    for key, value in dataclasses.asdict(ref).items():
        if key in back and key != "pairhmm_engine":
            assert back[key] == value, key


def test_config_from_reference_striped_runs_striped_kernel():
    """A reference config that asks for the striped kernel gives a port
    config whose cuda runner dispatches through it."""
    from gatk_hc_tpu_torch.ops.runner import PairHMMJob, TorchPairHMMRunner
    from tests.test_pairhmm import make_pair, to_bytes
    import random

    ref = dataclasses.replace(
        jax_config.DEFAULT_CONFIG, pallas_algo="striped", stripe_height=8,
        read_pad_buckets=(32,), hap_pad_buckets=(128,),
    )
    cfg = convert.config_from_reference(dataclasses.asdict(ref))
    read, quals, hap = make_pair(random.Random(3), 20, 60, 1)
    job = PairHMMJob([(to_bytes(read), to_bytes(quals))], [to_bytes(hap)])
    runner = TorchPairHMMRunner(cfg, device="cpu")
    runner.run([job])
    assert runner.dispatch_counts == {"striped": 1}
    assert np.isfinite(job.result).all()


def test_config_from_reference_rejects():
    """Unknown keys raise; the engine the port does not port (auto, which
    the reference's CLI resolves before a config exists) raises; the
    reference's "jax" and "shardmap" engines and its "jax" genotyper
    map."""
    d = dataclasses.asdict(jax_config.DEFAULT_CONFIG)
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_reference({**d, "no_such_key": 1})
    for engine in ("auto",):
        with pytest.raises(NotImplementedError):
            convert.config_from_reference({**d, "pairhmm_engine": engine})
    with pytest.raises(NotImplementedError):
        convert.config_from_reference({**d, "genotyper_engine": "gpu"})
    convert.config_from_reference({**d, "pairhmm_engine": "jax"})
    convert.config_from_reference({**d, "pairhmm_engine": "shardmap"})
    convert.config_from_reference({**d, "genotyper_engine": "jax"})


@pytest.mark.parametrize("engine,genotyper,want", [
    ("jax", "host", ("diag", "host")),
    ("pallas", "jax", ("cuda", "cuda")),
    ("native", "jax", ("native", "cuda")),
    ("python", "host", ("python", "host")),
    ("shardmap", "host", ("shardmap", "host")),
])
def test_config_from_reference_maps_engines(engine, genotyper, want):
    """The reference's engine names -> the port's: pallas -> cuda (the
    kernel engine), jax -> diag (the anti-diagonal engine), shardmap ->
    shardmap (the sharded step), and the device genotyper jax -> cuda."""
    ref = dataclasses.replace(jax_config.DEFAULT_CONFIG, pairhmm_engine=engine,
                              genotyper_engine=genotyper)
    got = convert.config_from_reference(dataclasses.asdict(ref))
    assert (got.pairhmm_engine, got.genotyper_engine) == want
