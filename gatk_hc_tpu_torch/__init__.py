"""gatk_hc_tpu_torch — the HaplotypeCaller engine on PyTorch and CUDA.

The second implementation of the engine in this repository, beside the JAX
package ``gatk_hc_tpu``, which stays the reference it is held against:

* host runtime (C++ via ctypes, the package's own copy): SAM/FASTA
  parsing, read filters/clipping, De Bruijn assembly, Smith-Waterman;
* device engine (PyTorch + hand-written CUDA kernels for Hopper): the
  PairHMM forward over batches of (read, haplotype) pairs
  (ops/pairhmm_torch.py, csrc/pairhmm_ppe.cu; ops/pairhmm_striped.py,
  csrc/pairhmm_striped.cu);
* orchestration (Python): region scheduling, cross-region batching
  (ops/runner.py), genotyping, VCF emission.

It imports no JAX and nothing of ``gatk_hc_tpu``; the tests compare the two
packages on the same inputs.
"""

__version__ = "0.1.0"

from .config import DEFAULT_CONFIG, HCConfig  # noqa: F401
