"""Model symbol builders of the port (counterpart of
``mxnet_tpu/models``): the image classifiers, SSD, the transformer LM and
the DLRM recommender.  ``get_dlrm`` builds the symbol and its row_sparse
slot config; ``sparse.SparseEmbeddingModule`` trains its tables through the
servers' row plane."""
from . import transformer  # noqa: F401
from .lenet import get_lenet
from .mlp import get_mlp
from .resnet import get_resnet
from .alexnet import get_alexnet
from .inception_bn import get_inception_bn
from .inception_v3 import get_inception_v3
from .vgg import get_vgg
from .googlenet import get_googlenet
from .ssd import get_ssd_train, get_ssd_detect, get_ssd_symbols
from .transformer import get_transformer_lm
from .dlrm import get_dlrm

__all__ = ["get_ssd_train", "get_ssd_detect", "get_ssd_symbols",
           "get_lenet", "get_mlp", "get_resnet", "get_alexnet",
           "get_inception_bn", "get_inception_v3", "get_vgg",
           "get_googlenet", "get_transformer_lm", "get_dlrm"]
