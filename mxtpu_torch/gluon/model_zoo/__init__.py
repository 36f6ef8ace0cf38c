"""Gluon model zoo of the PyTorch port (``mxtpu.gluon.model_zoo``)."""
from . import vision
from .vision import get_model
