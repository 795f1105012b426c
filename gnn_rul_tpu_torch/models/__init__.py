"""Models of the port. :data:`MODELS` maps each ported method to its
class; the serving entry point and the algorithm registry both read it:
the twelve aero-engine methods and the nine bearing methods."""

from .agcn_tf import AGCNTF
from .astgcnn import ASTGCNN
from .dvgtformer import DVGTformer
from .fc_stgnn import FCSTGNN
from .gat_lstm import GATLSTM
from .gdagdl import GDAGDL
from .gru_cm import GRUCM
from .hagcn import HAGCN
from .hiercorrpool import HierCorrPool
from .hiercorrpool_bearing import HierCorrPoolBearing
from .logo import LOGO
from .logo_bearing import LOGOBearing
from .rgcnu import RGCNU
from .sagcn import SAGCN
from .st_conv import STConv
from .st_gcn import STGCN
from .stagnn import STAGNN
from .stfa import STFA
from .stgnn import STGNN
from .stmsgcn import STMSGCN
from .stnet import STNet

MODELS = {"FC_STGNN": FCSTGNN, "LOGO": LOGO, "HAGCN": HAGCN,
          "RGCNU": RGCNU, "STAGNN": STAGNN, "STFA": STFA, "GRU_CM": GRUCM,
          "STGNN": STGNN, "DVGTformer": DVGTformer,
          "HierCorrPool": HierCorrPool, "ASTGCNN": ASTGCNN,
          "ST_Conv": STConv, "HierCorrPool_bearing": HierCorrPoolBearing,
          "ST_GCN": STGCN, "SAGCN": SAGCN, "AGCN_TF": AGCNTF,
          "STMSGCN": STMSGCN, "STNet": STNet, "GAT_LSTM": GATLSTM,
          "GDAGDL": GDAGDL, "LOGO_bearing": LOGOBearing}
