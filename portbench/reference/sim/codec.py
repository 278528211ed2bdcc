"""Bit-exact float <-> binary-string codec used by robot JSON files.

Port copy of ``evomotion_tpu/serialize/codec.py`` (numpy only): the port keeps
its own copy so that it imports no module of the JAX package; keep the two
in step (tests/test_torch_front_end.py compares them).

The reference stores every float in robot JSON as the 32-character string of
its IEEE-754 bit pattern so that save/load round-trips are bit exact
(reference: evo_motion_model/src/converter.cpp:128-147 float_to_binary_string /
binary_string_to_float, used by json_serializer.cpp:67-69).
"""

from __future__ import annotations

import struct


def float_to_binary_string(f: float) -> str:
    """IEEE-754 float32 bits of ``f`` as a 32-char '0'/'1' string (MSB first)."""
    (bits,) = struct.unpack("<I", struct.pack("<f", f))
    return format(bits, "032b")


def binary_string_to_float(s: str) -> float:
    """Inverse of :func:`float_to_binary_string`."""
    bits = int(s, 2) & 0xFFFFFFFF
    (value,) = struct.unpack("<f", struct.pack("<I", bits))
    return value
