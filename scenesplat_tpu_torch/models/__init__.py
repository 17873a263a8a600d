from .builder import MODELS, build_model
from .structure import PointBatch
from . import ptv3  # noqa: F401 (registers PT-v3m1)
from . import default  # noqa: F401 (registers LangPretrainer and the segmentor heads)
from .losses import build_criteria  # noqa: E402,F401
from . import ssl  # noqa: E402,F401 (registers SimDINOSSL, DefaultContrastiverSimDinoV2)
from . import ppt  # noqa: E402,F401 (registers PPT-v1m1, PPT-v1m2)
# registers SpUNet-v1m1, SpUNet-v1m2, SpUNet-v1m3, SpUNetNoSkipBase and PG-v1m1
from . import spunet, point_group  # noqa: E402,F401
# registers MSC-v1m1, MSC-v1m2 and CAC-v1m1
from . import msc, cac  # noqa: E402,F401
# registers PT-v2m1/m2/m3 and PointTransformer-{Seg,Cls,PartSeg}{26,38,50}
from . import ptv1, ptv2  # noqa: E402,F401
# registers MinkUNet14/18/34/50/101 and their A-D variants, SPVCNN, OACNNs
# and OctFormer-v1m1
from . import mink_unet, spvcnn, oacnns, octformer  # noqa: E402,F401
# registers ST-v1m2 and ST-v1m1
from . import stratified  # noqa: E402,F401
