"""Models of the port. :data:`MODELS` maps each ported method to its
class; the serving entry point and the algorithm registry both read it."""

from .fc_stgnn import FCSTGNN
from .logo import LOGO
from .stagnn import STAGNN
from .stfa import STFA

MODELS = {"FC_STGNN": FCSTGNN, "LOGO": LOGO, "STAGNN": STAGNN, "STFA": STFA}
