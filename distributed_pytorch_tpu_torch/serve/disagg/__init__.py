"""serve/disagg: disaggregated prefill/decode serving.

Prefill and decode run as separate engines, two loops in one process
(each on a CUDA stream of its own on the card), joined by a KV-page
handoff that ships a finished prompt's resident pages through
``comm/wire.py``'s block codec (per-page scales; ``DPX_HANDOFF_WIDTH``
selects f32, q8 or q4), so a long prompt never appears in the decode
loop and q8 / q4 frames carry ~4x / ~7.9x fewer KV bytes than f32.
:class:`~.router.DisaggEngine` is the front door.
"""

from .decode import DecodeEngine
from .frames import (HANDOFF_WIDTHS, HandoffFrame, decode_frame,
                     encode_frame, encode_frame_quantized, kv_wire_bytes,
                     resolve_handoff_bits)
from .prefill import PrefillEngine
from .router import DisaggConfig, DisaggEngine
from .transport import HostCommTransport, LocalTransport, TransportSevered

__all__ = [
    "DecodeEngine", "DisaggConfig", "DisaggEngine", "HANDOFF_WIDTHS",
    "HandoffFrame", "HostCommTransport", "LocalTransport", "PrefillEngine",
    "TransportSevered",
    "decode_frame", "encode_frame", "encode_frame_quantized",
    "kv_wire_bytes", "resolve_handoff_bits",
]
