"""gluon.nn: the layers with the reference's constructors (counterpart of
mxnet_tpu/gluon/nn/)."""
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from .moe import MoEFFN  # noqa: F401
