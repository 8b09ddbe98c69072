from tcgnn.models.layers import agnn_conv, gcn_conv, gin_conv, sag
from tcgnn.models.nets import MODEL_KINDS, apply_net, init_net

__all__ = [
    "agnn_conv", "gcn_conv", "gin_conv", "sag",
    "MODEL_KINDS", "apply_net", "init_net",
]
