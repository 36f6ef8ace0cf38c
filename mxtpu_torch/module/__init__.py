"""Module layer of the PyTorch port; so far only the program cache that
the serving engine shares with the (not yet ported) fused trainer."""
from .fused import ProgramCache

__all__ = ["ProgramCache"]
