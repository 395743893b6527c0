"""Portable XLA formulations of PHY hot ops (polyphase super-frame FIR)."""
from __future__ import annotations

from .polyphase import (
    SuperframeDesign,
    make_superframe_design,
    polyphase_fir_xla,
)

__all__ = [
    "SuperframeDesign",
    "make_superframe_design",
    "polyphase_fir_xla",
]
