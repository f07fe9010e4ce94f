from .ap import DetectionAPMeter, ap_11_point, ap_auc, ap_interpolated  # noqa: F401
from .association import BoxAssociation, BoxPairAssociation  # noqa: F401
