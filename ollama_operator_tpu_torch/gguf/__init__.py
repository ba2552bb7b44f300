from .reader import GGUFFile, GGUFTensor  # noqa: F401
from . import dequant  # noqa: F401
