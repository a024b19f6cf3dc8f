"""Shared discrete-event simulation core (DESIGN.md S6): the port's copy
of ``repro.sim``."""
from .engine import EventHeap, IndexQueue, Ledger

__all__ = ["EventHeap", "IndexQueue", "Ledger"]
