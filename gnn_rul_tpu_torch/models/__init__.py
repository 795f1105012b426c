"""Models of the port. :data:`MODELS` maps each ported method to its
class; the serving entry point and the algorithm registry both read it."""

from .astgcnn import ASTGCNN
from .dvgtformer import DVGTformer
from .fc_stgnn import FCSTGNN
from .gru_cm import GRUCM
from .hagcn import HAGCN
from .hiercorrpool import HierCorrPool
from .logo import LOGO
from .rgcnu import RGCNU
from .st_conv import STConv
from .stagnn import STAGNN
from .stfa import STFA
from .stgnn import STGNN

MODELS = {"FC_STGNN": FCSTGNN, "LOGO": LOGO, "HAGCN": HAGCN,
          "RGCNU": RGCNU, "STAGNN": STAGNN, "STFA": STFA, "GRU_CM": GRUCM,
          "STGNN": STGNN, "DVGTformer": DVGTformer,
          "HierCorrPool": HierCorrPool, "ASTGCNN": ASTGCNN,
          "ST_Conv": STConv}
