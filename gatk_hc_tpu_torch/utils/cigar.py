"""CIGAR strings, as immutable tuples of ``(length, op)`` pairs.

Semantics mirror hc::Cigar / hc::CigarOperator (reference sam/cigar.hpp):
ops M/I/D/N/S/H/P/=/X, reference-consumed length counts M/D/N/=/X, and
read-consumed length counts M/I/S/=/X.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

CigarElement = Tuple[int, str]
Cigar = Tuple[CigarElement, ...]

_REF_CONSUMING = frozenset("MDN=X")
_READ_CONSUMING = frozenset("MIS=X")
_VALID_OPS = frozenset("MIDNSHP=X")


def parse_cigar(text: str) -> Cigar:
    """Parse e.g. ``"10M2I88M"`` -> ((10,'M'), (2,'I'), (88,'M'))."""
    if text == "*" or not text:
        return ()
    elements: List[CigarElement] = []
    length = 0
    saw_digit = False
    for ch in text:
        if ch.isdigit():
            length = length * 10 + ord(ch) - ord("0")
            saw_digit = True
        else:
            if ch not in _VALID_OPS or not saw_digit:
                raise ValueError(f"bad CIGAR {text!r}")
            elements.append((length, ch))
            length = 0
            saw_digit = False
    if saw_digit:
        raise ValueError(f"bad CIGAR {text!r} (trailing length)")
    return tuple(elements)


def cigar_to_string(cigar: Iterable[CigarElement]) -> str:
    return "".join(f"{length}{op}" for length, op in cigar)


def reference_length(cigar: Iterable[CigarElement]) -> int:
    return sum(length for length, op in cigar if op in _REF_CONSUMING)


def read_length(cigar: Iterable[CigarElement]) -> int:
    return sum(length for length, op in cigar if op in _READ_CONSUMING)


def reverse_cigar(cigar: Cigar) -> Cigar:
    return tuple(reversed(cigar))


def contains_op(cigar: Cigar, op: str) -> bool:
    return any(o == op for _, o in cigar)
