"""Decoder-only transformer LM symbol builder — counterpart of
``mxnet_tpu/models/transformer.py::get_transformer_lm``.

The graph is built from the same ops with the same names in the same order,
so under a fresh ``NameManager`` its JSON is byte-identical to the JAX
package's and one checkpoint serves both.  Attention is
``_contrib_FlashAttention`` (``attn_impl="flash"``) or
``_contrib_SplashAttention`` (``"splash"``), both on the CUDA attention
kernels on the card.
"""

from .. import symbol as sym


def _dense(x, n_in, n_out, name):
    """FC over the trailing dim of a (b, s, d) tensor: reshape to rows."""
    h = sym.Reshape(x, shape=(-1, n_in))
    h = sym.FullyConnected(h, num_hidden=n_out, name=name)
    return h


def _block(x, hidden, num_heads, seq_len, name, block_q=None, block_k=None,
           attn_impl="flash"):
    head_dim = hidden // num_heads
    # attention sublayer (pre-norm)
    h = sym.LayerNorm(x, name="%s_ln1" % name)
    qkv = _dense(h, hidden, 3 * hidden, "%s_qkv" % name)
    qkv = sym.Reshape(qkv, shape=(-1, seq_len, 3, num_heads, head_dim))
    q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=2, squeeze_axis=True,
                               name="%s_split" % name)
    if attn_impl == "splash":
        att = sym._contrib_SplashAttention(q, k, v, causal=True,
                                           name="%s_attn" % name)
    elif attn_impl == "flash":
        att = sym._contrib_FlashAttention(q, k, v, causal=True,
                                          block_q=block_q, block_k=block_k,
                                          name="%s_attn" % name)
    else:
        raise ValueError("attn_impl must be 'flash' or 'splash', got %r"
                         % (attn_impl,))
    att = sym.Reshape(att, shape=(-1, seq_len, hidden))
    proj = _dense(att, hidden, hidden, "%s_proj" % name)
    x = sym.broadcast_add(x, sym.Reshape(proj, shape=(-1, seq_len, hidden)),
                          name="%s_res1" % name)
    # mlp sublayer (pre-norm, gelu)
    h = sym.LayerNorm(x, name="%s_ln2" % name)
    h = _dense(h, hidden, 4 * hidden, "%s_fc1" % name)
    h = sym.gelu(h, name="%s_gelu" % name)
    h = _dense(h, 4 * hidden, hidden, "%s_fc2" % name)
    return sym.broadcast_add(x, sym.Reshape(h, shape=(-1, seq_len, hidden)),
                             name="%s_res2" % name)


def get_transformer_lm(vocab_size=32000, num_layers=4, num_heads=8,
                       hidden=512, seq_len=128, block_q=None, block_k=None,
                       attn_impl="flash"):
    """Causal LM: data (b, seq_len) token ids -> SoftmaxOutput over the
    vocab at every position (label (b*seq_len,) next-token ids)."""
    data = sym.Variable("data")
    pos = sym.Variable("pos_embed_weight", shape=(1, seq_len, hidden))
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=hidden,
                      name="tok_embed")
    x = sym.broadcast_add(x, pos, name="pos_add")
    for i in range(num_layers):
        x = _block(x, hidden, num_heads, seq_len, "layer%d" % i,
                   block_q=block_q, block_k=block_k, attn_impl=attn_impl)
    x = sym.LayerNorm(x, name="ln_f")
    logits = _dense(x, hidden, vocab_size, "lm_head")  # (b*s, vocab)
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(logits, label=label, name="softmax")
