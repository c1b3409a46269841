"""Decoder-only transformer LM symbol builder — counterpart of
``mxnet_tpu/models/transformer.py::get_transformer_lm``.

The graph is built from the same ops with the same names in the same order,
so under a fresh ``NameManager`` its JSON is byte-identical to the JAX
package's and one checkpoint serves both.  Attention is
``_contrib_FlashAttention`` (``attn_impl="flash"``) or
``_contrib_SplashAttention`` (``"splash"``), both on the CUDA attention
kernels on the card.

The generation builders (prefill, verify, catch-up, decode) are the JAX
package's too, op for op, over the same weight names, so one
``get_transformer_lm`` checkpoint binds all of them.
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


# ---------------------------------------------------------------------------
# Generative-serving variants (generation/) — same weight names as
# get_transformer_lm, so one trained checkpoint binds all three symbols.
# ---------------------------------------------------------------------------


def _prefill_block(x, hidden, num_heads, seq_len, name, attn_impl):
    """Pre-norm block that also RETURNS its (k, v) projections — the
    prefill pass feeds them into the paged KV pool so decode never
    recomputes the prefix."""
    head_dim = hidden // num_heads
    h = sym.LayerNorm(x, name="%s_ln1" % name)
    qkv = _dense(h, hidden, 3 * hidden, "%s_qkv" % name)
    qkv = sym.Reshape(qkv, shape=(-1, seq_len, 3, num_heads, head_dim))
    q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=2, squeeze_axis=True,
                               name="%s_split" % name)
    if attn_impl == "dense":
        # dense attention (the generation engine's prefill, as in the
        # JAX package); "flash" runs K1 instead
        att = sym._contrib_DenseAttention(q, k, v, causal=True,
                                          name="%s_attn" % name)
    elif attn_impl == "flash":
        att = sym._contrib_FlashAttention(q, k, v, causal=True,
                                          name="%s_attn" % name)
    else:
        raise ValueError("attn_impl must be 'dense' or 'flash', got %r"
                         % (attn_impl,))
    att = sym.Reshape(att, shape=(-1, seq_len, hidden))
    proj = _dense(att, hidden, hidden, "%s_proj" % name)
    x = sym.broadcast_add(x, sym.Reshape(proj, shape=(-1, seq_len, hidden)),
                          name="%s_res1" % name)
    h = sym.LayerNorm(x, name="%s_ln2" % name)
    h = _dense(h, hidden, 4 * hidden, "%s_fc1" % name)
    h = sym.gelu(h, name="%s_gelu" % name)
    h = _dense(h, 4 * hidden, hidden, "%s_fc2" % name)
    x = sym.broadcast_add(x, sym.Reshape(h, shape=(-1, seq_len, hidden)),
                          name="%s_res2" % name)
    return x, k, v


def get_transformer_lm_prefill(vocab_size=32000, num_layers=4, num_heads=8,
                               hidden=512, seq_len=128, max_seq_len=None,
                               attn_impl="dense"):
    """Prefill pass for generation: ``data`` (b, seq_len) token ids ->
    ``Group([logits, k0, v0, k1, v1, ...])`` with logits (b, seq_len,
    vocab) and per-layer K/V (b, seq_len, heads, head_dim).

    ``seq_len`` is this executable's (bucketed) prompt capacity;
    ``max_seq_len`` (default ``seq_len``) is the position-table capacity
    shared with the training symbol — the engine builds one prefill
    executor per length bucket against one ``pos_embed_weight``.
    Prompts shorter than ``seq_len`` are right-padded by the caller;
    causal attention keeps the padding from contaminating real
    positions, so only outputs at < length are meaningful."""
    if max_seq_len is None:
        max_seq_len = seq_len
    data = sym.Variable("data")
    pos = sym.Variable("pos_embed_weight", shape=(1, max_seq_len, hidden))
    if seq_len != max_seq_len:
        pos = sym.slice_axis(pos, axis=1, begin=0, end=seq_len,
                             name="pos_slice")
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=hidden,
                      name="tok_embed")
    x = sym.broadcast_add(x, pos, name="pos_add")
    kvs = []
    for i in range(num_layers):
        x, k, v = _prefill_block(x, hidden, num_heads, seq_len,
                                 "layer%d" % i, attn_impl)
        kvs.extend([k, v])
    x = sym.LayerNorm(x, name="ln_f")
    logits = _dense(x, hidden, vocab_size, "lm_head")
    logits = sym.Reshape(logits, shape=(-1, seq_len, vocab_size),
                         name="logits")
    return sym.Group([logits] + kvs)


def get_transformer_lm_verify(vocab_size=32000, num_layers=4, num_heads=8,
                              hidden=512, max_seq_len=128, lanes=8,
                              num_pages=64, page_size=16, max_pages=8,
                              width=4):
    """Speculative-decoding verification: ``width`` sequential decode
    steps over paged KV fused into ONE executable, so the target model
    scores a drafted token run in a single dispatch.

    Inputs: ``data`` (lanes, width) token ids — position ``w`` of a lane
    is the token fed at step ``w`` (the last accepted token followed by
    draft proposals); ``positions`` (lanes, width) their absolute
    positions; ``page_table`` (lanes, max_pages); per-layer
    ``layer%d_k_pool`` / ``layer%d_v_pool``.  Output:
    ``Group([logits_0 .. logits_{width-1}, k_pool0_out, v_pool0_out,
    ...])`` with each logits (lanes, vocab).

    Bit-identity by construction: the graph is literally ``width``
    copies of :func:`get_transformer_lm_decode`'s per-token block —
    same ops, same shapes, same paged-attention numerics — chained
    through the pool outputs, so greedy argmax over ``logits_w`` equals
    what ``width`` separate decode steps would produce.  Weights are
    shared across the copies via explicit parameter variables carrying
    the training checkpoint's names."""
    head_dim = hidden // num_heads
    data = sym.Variable("data")
    positions = sym.Variable("positions")
    page_table = sym.Variable("page_table")
    pos_tab = sym.Variable("pos_embed_weight", shape=(1, max_seq_len, hidden))
    pe_flat = sym.Reshape(pos_tab, shape=(max_seq_len, hidden),
                          name="pos_flat")
    embed_w = sym.Variable("tok_embed_weight")

    def _params(name, outs):
        return {"weight": sym.Variable("%s_weight" % name),
                "bias": sym.Variable("%s_bias" % name),
                "num_hidden": outs}

    def _norm(name):
        return {"gamma": sym.Variable("%s_gamma" % name),
                "beta": sym.Variable("%s_beta" % name)}

    k_pools = [sym.Variable("layer%d_k_pool" % i) for i in range(num_layers)]
    v_pools = [sym.Variable("layer%d_v_pool" % i) for i in range(num_layers)]
    logits_outs = []
    for w in range(width):
        tag = "_s%d" % w
        tok = sym.Reshape(sym.slice_axis(data, axis=1, begin=w, end=w + 1,
                                         name="tok_slice%s" % tag),
                          shape=(-1,), name="tok%s" % tag)
        pos_w = sym.Reshape(sym.slice_axis(positions, axis=1, begin=w,
                                           end=w + 1,
                                           name="pos_slice%s" % tag),
                            shape=(-1,), name="pos%s" % tag)
        x = sym.Embedding(tok, weight=embed_w, input_dim=vocab_size,
                          output_dim=hidden, name="tok_embed%s" % tag)
        pe = sym.take(pe_flat, pos_w, name="pos_take%s" % tag)
        x = sym.broadcast_add(x, pe, name="pos_add%s" % tag)
        for i in range(num_layers):
            name = "layer%d" % i
            h = sym.LayerNorm(x, name="%s_ln1%s" % (name, tag),
                              **_norm("%s_ln1" % name))
            qkv = sym.FullyConnected(h, name="%s_qkv%s" % (name, tag),
                                     **_params("%s_qkv" % name, 3 * hidden))
            qkv = sym.Reshape(qkv, shape=(-1, 3, num_heads, head_dim),
                              name="%s_qkvr%s" % (name, tag))
            q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=1,
                                       squeeze_axis=True,
                                       name="%s_split%s" % (name, tag))
            att, k_out, v_out = sym._contrib_PagedAttention(
                q, k, v, k_pools[i], v_pools[i], page_table, pos_w,
                page_size=page_size, name="%s_attn%s" % (name, tag))
            k_pools[i], v_pools[i] = k_out, v_out
            att = sym.Reshape(att, shape=(-1, hidden),
                              name="%s_attr%s" % (name, tag))
            proj = sym.FullyConnected(att, name="%s_proj%s" % (name, tag),
                                      **_params("%s_proj" % name, hidden))
            x = sym.broadcast_add(x, proj, name="%s_res1%s" % (name, tag))
            h = sym.LayerNorm(x, name="%s_ln2%s" % (name, tag),
                              **_norm("%s_ln2" % name))
            h = sym.FullyConnected(h, name="%s_fc1%s" % (name, tag),
                                   **_params("%s_fc1" % name, 4 * hidden))
            h = sym.gelu(h, name="%s_gelu%s" % (name, tag))
            h = sym.FullyConnected(h, name="%s_fc2%s" % (name, tag),
                                   **_params("%s_fc2" % name, hidden))
            x = sym.broadcast_add(x, h, name="%s_res2%s" % (name, tag))
        x = sym.LayerNorm(x, name="ln_f%s" % tag, **_norm("ln_f"))
        logits = sym.FullyConnected(x, name="lm_head%s" % tag,
                                    **_params("lm_head", vocab_size))
        logits_outs.append(logits)
    pools_out = []
    for i in range(num_layers):
        pools_out.extend([k_pools[i], v_pools[i]])
    return sym.Group(logits_outs + pools_out)


def get_transformer_lm_catchup(vocab_size=32000, num_layers=4, num_heads=8,
                               hidden=512, max_seq_len=128, lanes=8,
                               num_pages=64, page_size=16, max_pages=8,
                               width=4):
    """Windowed teacher-forcing pass: ``width`` KNOWN tokens per lane
    advance in ONE forward over paged KV.  The tokens come from a
    prefix-cache hit's suffix, a re-admitted preemptee's transcript, or
    a speculative draft's proposals — in every case nothing has to wait
    for the previous slot's argmax, so the sequential decode chain is
    unnecessary.

    Unlike :func:`get_transformer_lm_verify` — the older construction
    that chains ``width`` literal copies of the decode block and pays
    its dispatch cost ``width`` times — this is a single causal pass:
    every projection runs batched over ``lanes * width`` rows and each
    layer gathers the paged history once
    (``_contrib_PagedAttentionWindow``), so the cost scales like a
    short prefill instead of ``width`` decode steps.  It writes the
    same K/V slots and attends the same masked history, and the
    engine's parity tests assert transcript equality against plain
    decode.

    Inputs: ``data`` (lanes, width) token ids; ``positions``
    (lanes, width) absolute positions (pad slots at
    ``max_seq_len - 1`` with a zero page-table row park in scratch);
    ``page_table`` (lanes, max_pages); per-layer pools.  Output:
    ``Group([logits, k_pool0_out, v_pool0_out, ...])`` with logits
    (lanes * width, vocab) — row ``lane * width + w`` scores window
    slot ``w``."""
    head_dim = hidden // num_heads
    data = sym.Variable("data")
    positions = sym.Variable("positions")
    page_table = sym.Variable("page_table")
    pos_tab = sym.Variable("pos_embed_weight", shape=(1, max_seq_len, hidden))
    tok = sym.Reshape(data, shape=(-1,), name="tok_flat")
    x = sym.Embedding(tok, input_dim=vocab_size, output_dim=hidden,
                      name="tok_embed")
    pe = sym.Reshape(pos_tab, shape=(max_seq_len, hidden), name="pos_flat")
    pos_flat = sym.Reshape(positions, shape=(-1,), name="pos_ids_flat")
    pe = sym.take(pe, pos_flat, name="pos_take")  # (lanes*width, hidden)
    x = sym.broadcast_add(x, pe, name="pos_add")
    pools_out = []
    for i in range(num_layers):
        name = "layer%d" % i
        h = sym.LayerNorm(x, name="%s_ln1" % name)
        qkv = sym.FullyConnected(h, num_hidden=3 * hidden,
                                 name="%s_qkv" % name)
        qkv = sym.Reshape(qkv, shape=(-1, 3, num_heads, head_dim))
        q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=1,
                                   squeeze_axis=True, name="%s_split" % name)
        k_pool = sym.Variable("%s_k_pool" % name)
        v_pool = sym.Variable("%s_v_pool" % name)
        att, k_out, v_out = sym._contrib_PagedAttentionWindow(
            q, k, v, k_pool, v_pool, page_table, positions,
            page_size=page_size, name="%s_attn" % name)
        pools_out.extend([k_out, v_out])
        att = sym.Reshape(att, shape=(-1, hidden))
        proj = sym.FullyConnected(att, num_hidden=hidden,
                                  name="%s_proj" % name)
        x = sym.broadcast_add(x, proj, name="%s_res1" % name)
        h = sym.LayerNorm(x, name="%s_ln2" % name)
        h = sym.FullyConnected(h, num_hidden=4 * hidden,
                               name="%s_fc1" % name)
        h = sym.gelu(h, name="%s_gelu" % name)
        h = sym.FullyConnected(h, num_hidden=hidden, name="%s_fc2" % name)
        x = sym.broadcast_add(x, h, name="%s_res2" % name)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, name="lm_head")
    return sym.Group([logits] + pools_out)


def get_transformer_lm_decode(vocab_size=32000, num_layers=4, num_heads=8,
                              hidden=512, max_seq_len=128, lanes=8,
                              num_pages=64, page_size=16, max_pages=8):
    """One incremental decode step over paged KV: ``lanes`` sequences
    advance one token each, reading/writing fixed-size KV pages through
    per-lane page tables instead of recomputing the prefix.

    Inputs: ``data`` (lanes,) current token ids; ``positions`` (lanes,)
    absolute positions; ``page_table`` (lanes, max_pages);
    ``layer%d_k_pool`` / ``layer%d_v_pool`` (num_pages, page_size,
    heads, head_dim) per layer.  Output: ``Group([logits, k_pool0_out,
    v_pool0_out, ...])`` with logits (lanes, vocab).  Everything is
    static-shape, so one executable per lane count serves any mix of
    sequence lengths — the continuous-batching contract."""
    head_dim = hidden // num_heads
    data = sym.Variable("data")
    positions = sym.Variable("positions")
    page_table = sym.Variable("page_table")
    pos_tab = sym.Variable("pos_embed_weight", shape=(1, max_seq_len, hidden))
    x = sym.Embedding(data, input_dim=vocab_size, output_dim=hidden,
                      name="tok_embed")
    pe = sym.Reshape(pos_tab, shape=(max_seq_len, hidden), name="pos_flat")
    pe = sym.take(pe, positions, name="pos_take")  # (lanes, hidden)
    x = sym.broadcast_add(x, pe, name="pos_add")
    pools_out = []
    for i in range(num_layers):
        name = "layer%d" % i
        h = sym.LayerNorm(x, name="%s_ln1" % name)
        qkv = sym.FullyConnected(h, num_hidden=3 * hidden,
                                 name="%s_qkv" % name)
        qkv = sym.Reshape(qkv, shape=(-1, 3, num_heads, head_dim))
        q, k, v = sym.SliceChannel(qkv, num_outputs=3, axis=1,
                                   squeeze_axis=True, name="%s_split" % name)
        k_pool = sym.Variable("%s_k_pool" % name)
        v_pool = sym.Variable("%s_v_pool" % name)
        att, k_out, v_out = sym._contrib_PagedAttention(
            q, k, v, k_pool, v_pool, page_table, positions,
            page_size=page_size, name="%s_attn" % name)
        pools_out.extend([k_out, v_out])
        att = sym.Reshape(att, shape=(-1, hidden))
        proj = sym.FullyConnected(att, num_hidden=hidden,
                                  name="%s_proj" % name)
        x = sym.broadcast_add(x, proj, name="%s_res1" % name)
        h = sym.LayerNorm(x, name="%s_ln2" % name)
        h = sym.FullyConnected(h, num_hidden=4 * hidden,
                               name="%s_fc1" % name)
        h = sym.gelu(h, name="%s_gelu" % name)
        h = sym.FullyConnected(h, num_hidden=hidden, name="%s_fc2" % name)
        x = sym.broadcast_add(x, h, name="%s_res2" % name)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, name="lm_head")
    return sym.Group([logits] + pools_out)
