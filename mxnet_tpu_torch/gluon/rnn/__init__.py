"""``gluon.rnn`` — recurrent layers and cells (counterpart of
``mxnet_tpu.gluon.rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridSequentialRNNCell, LSTMCell, LSTMPCell,
                       ModifierCell, RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, VariationalDropoutCell,
                       ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RNN", "LSTM", "GRU", "RecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "DropoutCell", "ModifierCell", "ResidualCell", "ZoneoutCell",
           "BidirectionalCell", "VariationalDropoutCell", "LSTMPCell"]
