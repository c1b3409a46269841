"""DLRM / two-tower recommender symbol builder, the counterpart of
``mxnet_tpu/models/dlrm.py``: per-slot embedding bags over vocabularies that
dwarf device memory + a dense-feature MLP tower, concatenated into a top MLP
with a logistic CTR head.

The graph is built from the same ops with the same names in the same order,
so under a fresh ``NameManager`` its JSON is byte-identical to the JAX
package's and one checkpoint serves both.

Each Embedding binds ``input_dim=capacity`` (the max distinct rows one batch
touches), NOT the vocabulary.  ``sparse_slots`` is the routing config of
``sparse.SparseEmbeddingModule``, which remaps ids per batch to positions
below the capacity and pulls only the touched rows from the servers'
sharded tables of the full vocabularies.  Served alone (``Predictor``, the
platform), a table holds ``capacity`` rows and ids must be drawn in
``[0, capacity)`` (the port's ``Embedding`` clips an id past the table
where the JAX package gives NaN).

``get_dlrm`` returns ``(symbol, sparse_slots)`` — the symbol and the
matching routing config are built together so the capacity/input_dim
invariant cannot drift.
"""

from .. import symbol as sym

__all__ = ["get_dlrm"]


def get_dlrm(num_slots=4, vocab_sizes=None, embed_dim=16, capacity=256,
             bag_len=8, dense_dim=13, bottom_hidden=(64, 16),
             top_hidden=(64, 32), init=("uniform", 0.01)):
    """Build the DLRM symbol + row_sparse slot config.

    Inputs: ``dense`` (batch, dense_dim) float features and one
    ``slot<i>_indices`` (batch, bag_len) id array per slot (multi-hot
    bags, sum-pooled).  Label: ``ctr_label`` (batch,) clicks.
    """
    if vocab_sizes is None:
        vocab_sizes = [100000] * num_slots
    if len(vocab_sizes) != num_slots:
        raise ValueError("need one vocab size per slot")

    # bottom (dense) tower
    net = sym.Variable("dense")
    for i, h in enumerate(bottom_hidden):
        net = sym.FullyConnected(data=net, num_hidden=h,
                                 name="bot_fc%d" % i)
        net = sym.Activation(data=net, act_type="relu",
                             name="bot_relu%d" % i)
    towers = [net]

    # sparse towers: Embedding bound at capacity rows, sum-pooled bags
    sparse_slots = {}
    for i, vocab in enumerate(vocab_sizes):
        name = "slot%d" % i
        ids = sym.Variable("%s_indices" % name)
        emb = sym.Embedding(data=ids, input_dim=capacity,
                            output_dim=embed_dim,
                            name="%s_embed" % name)
        towers.append(sym.sum(emb, axis=1, name="%s_bag" % name))
        sparse_slots[name] = {
            "data": "%s_indices" % name,
            "weight": "%s_embed_weight" % name,
            "num_rows": int(vocab),
            "capacity": int(capacity),
            "init": tuple(init),
        }

    net = sym.Concat(*towers, num_args=len(towers), dim=1, name="interact")
    for i, h in enumerate(top_hidden):
        net = sym.FullyConnected(data=net, num_hidden=h,
                                 name="top_fc%d" % i)
        net = sym.Activation(data=net, act_type="relu",
                             name="top_relu%d" % i)
    net = sym.FullyConnected(data=net, num_hidden=1, name="ctr_fc")
    net = sym.LogisticRegressionOutput(data=net, name="ctr")
    return net, sparse_slots
