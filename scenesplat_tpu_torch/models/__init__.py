from .builder import MODELS, build_model
from .structure import PointBatch
from . import ptv3  # noqa: F401 (registers PT-v3m1)
from . import default  # noqa: F401 (registers LangPretrainer)
from .losses import build_criteria  # noqa: E402,F401
