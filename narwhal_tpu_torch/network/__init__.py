"""Host-side transport: TCP with length-delimited frames.

Mirrors the reference `network` crate (≈480 LoC): a `Receiver` dispatching
frames to a `MessageHandler` that can reply on the same socket, a
fire-and-forget `SimpleSender`, and an at-least-once `ReliableSender` whose
per-message futures double as delivery (quorum-counting) signals.  This is
deliberately host-side TCP: BFT peers are mutually untrusting machines, so
inter-authority traffic can never ride ICI collectives (SURVEY.md §2.4) —
the TPU surface is within an authority, not between them.
"""

from .framing import read_frame, write_frame, FrameError, MAX_FRAME
from .receiver import Receiver, Writer
from .simple_sender import SimpleSender
from .reliable_sender import ReliableSender

__all__ = [
    "read_frame",
    "write_frame",
    "FrameError",
    "MAX_FRAME",
    "Receiver",
    "Writer",
    "SimpleSender",
    "ReliableSender",
]
