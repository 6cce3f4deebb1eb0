"""Wire framing and the v2 message codec.

The receiver and the senders (the TCP transport of the reference's
``network`` package) arrive with the node; until then this package
carries only what message encoding needs.
"""

from .framing import read_frame, write_frame, FrameError, MAX_FRAME

__all__ = [
    "read_frame",
    "write_frame",
    "FrameError",
    "MAX_FRAME",
]
