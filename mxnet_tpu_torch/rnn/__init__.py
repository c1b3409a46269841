"""RNN cells and the bucketed sentence iterator; counterpart of
``mxnet_tpu/rnn/``."""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)
from .io import BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter"]
