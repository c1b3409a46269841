"""Regex partition rules: dotted/underscored parameter names ->
``PartitionSpec``; counterpart of ``mxnet_tpu/sharding/rules.py``, with
``parallel.mesh.PartitionSpec`` for the JAX one.

The SNIPPETS.md [2] ``match_partition_rules`` pattern, grown into the
framework's single source of layout truth: an ORDERED list of
``(regex, PartitionSpec)`` pairs is matched (``re.search``) against each
parameter name; the first hit wins.  Scalars and single-element arrays
short-circuit to replicated (there is nothing to split), and every
resolution is explainable — :meth:`PartitionRules.explain` reports which
rule claimed each parameter, so a layout regression is a diffable table
(``python -m mxnet_tpu_torch.tools.shard_probe`` prints it) instead of an
OOM three hours into a run.

Presets encode the bench-model layouts:

* ``replicated`` — pure data parallelism, every parameter on every device
  (exactly the pre-sharding executor_group behavior, now as data);
* ``transformer_megatron`` — Megatron-style tensor parallelism for the
  ``models.transformer`` LM family: attention qkv / MLP fc1 split by
  output rows (column-parallel), proj / fc2 split by input columns
  (row-parallel), vocab-parallel lm_head, norms replicated.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError
from ..parallel.mesh import PartitionSpec

__all__ = ["PartitionRules", "as_rules", "match_partition_rules",
           "explain_partition_rules", "get_preset", "PRESETS"]


def _pspec():
    return PartitionSpec


def _leaf_shape(leaf):
    """Shape of a rule-matching leaf: array-likes expose .shape; tuples/
    lists of ints are taken as shapes directly (so rules resolve from
    ``infer_shape`` output before any array exists)."""
    shape = getattr(leaf, "shape", None)
    if shape is not None:
        return tuple(shape)
    if isinstance(leaf, (tuple, list)) and \
            all(isinstance(d, (int, np.integer)) for d in leaf):
        return tuple(int(d) for d in leaf)
    raise MXNetError(
        "cannot derive a shape for partition-rule matching from %r" % (leaf,))


class PartitionRules:
    """Ordered (regex, PartitionSpec) rules with an optional replicated
    fallback.

    ``fallback``: a PartitionSpec used when no rule matches (pass
    ``PartitionSpec()`` for replicate-unmatched); ``None`` makes an
    unmatched parameter a hard error naming the parameter — the safe
    default for hand-written rule sets, where a typo silently replicating
    a 10 GB embedding is the failure mode to catch.
    """

    def __init__(self, rules: Sequence[Tuple[str, object]], fallback=None,
                 name: str = "custom"):
        self.name = name
        self.fallback = fallback
        self.rules = []
        for pattern, spec in rules:
            try:
                self.rules.append((re.compile(pattern), spec))
            except re.error as e:
                raise MXNetError(
                    "bad partition-rule regex %r: %s" % (pattern, e))

    # ------------------------------------------------------------------
    def spec_for(self, param_name: str, shape) -> object:
        """Resolve one name (+shape, for the scalar short-circuit)."""
        spec, _ = self._resolve(param_name, shape)
        return spec

    def _resolve(self, param_name, shape):
        P = _pspec()
        shape = _leaf_shape(shape)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P(), "<scalar>"
        for regex, spec in self.rules:
            if regex.search(param_name) is not None:
                return spec, regex.pattern
        if self.fallback is not None:
            return self.fallback, "<fallback>"
        raise MXNetError(
            "no partition rule matches parameter %r (shape %s); add a rule "
            "or a replicated fallback (fallback=PartitionSpec())"
            % (param_name, shape))

    def match(self, params: Dict[str, object]) -> Dict[str, object]:
        """{name: array-or-shape} -> {name: PartitionSpec}."""
        return {name: self._resolve(name, leaf)[0]
                for name, leaf in params.items()}

    def explain(self, params: Dict[str, object]) -> List[dict]:
        """Per-parameter resolution report: which rule claimed each name.

        Rows: {"param", "shape", "rule", "spec"} where ``rule`` is the
        matching regex pattern, ``<scalar>`` (short-circuit), or
        ``<fallback>``.
        """
        rows = []
        for name, leaf in params.items():
            spec, rule = self._resolve(name, leaf)
            rows.append({"param": name, "shape": _leaf_shape(leaf),
                         "rule": rule, "spec": tuple(spec)})
        return rows

    def explain_str(self, params: Dict[str, object]) -> str:
        rows = self.explain(params)
        w = max([len(r["param"]) for r in rows] + [5])
        lines = ["%-*s  %-18s  %-24s  %s" % (w, "param", "shape", "spec",
                                             "rule")]
        for r in rows:
            lines.append("%-*s  %-18s  %-24s  %s" % (
                w, r["param"], r["shape"], r["spec"], r["rule"]))
        return "\n".join(lines)

    def __repr__(self):
        return "PartitionRules(%s, %d rules, fallback=%s)" % (
            self.name, len(self.rules), self.fallback)


def as_rules(rules, fallback="unset") -> "PartitionRules":
    """Coerce any accepted rule form: a preset name, a PartitionRules, or
    a raw ``[(regex, spec), ...]`` list (fallback defaults to None for raw
    lists — unmatched raises)."""
    if isinstance(rules, PartitionRules):
        return rules
    if isinstance(rules, str):
        return get_preset(rules)
    return PartitionRules(rules,
                          fallback=None if fallback == "unset" else fallback)


def match_partition_rules(rules, params, fallback="unset"):
    """Functional form (the SNIPPETS.md [2] surface): ordered
    ``(regex, PartitionSpec)`` rules over ``{name: array-or-shape}`` ->
    ``{name: PartitionSpec}``, scalars replicated, unmatched raising unless
    a ``fallback`` spec is given."""
    return as_rules(rules, fallback).match(params)


def explain_partition_rules(rules, params, fallback="unset"):
    """Like :func:`match_partition_rules` but returns the per-param
    explanation rows instead of bare specs."""
    return as_rules(rules, fallback).explain(params)


# ----------------------------------------------------------------------
# presets for the bench model families
# ----------------------------------------------------------------------
def _replicated() -> PartitionRules:
    P = _pspec()
    return PartitionRules([], fallback=P(), name="replicated")


def _resnet() -> PartitionRules:
    # ResNet-50 at bench scale fits every device: pure data parallelism,
    # parameters replicated, batch on the 'data' axis (the pre-sharding
    # executor_group layout expressed as rules)
    P = _pspec()
    return PartitionRules([], fallback=P(), name="resnet")


def _transformer_megatron() -> PartitionRules:
    # models/transformer.py naming: layerN_{qkv,proj,fc1,fc2}_{weight,bias},
    # tok_embed/pos_embed, lm_head, *_ln*/ln_f norms.  FullyConnected
    # weights are (out, in) — column-parallel shards rows (axis 0),
    # row-parallel shards columns (axis 1).  Row-parallel biases stay
    # replicated (added once after the partial-sum reduce).
    P = _pspec()
    return PartitionRules([
        (r"_(qkv|fc1)_weight$", P("model", None)),   # column parallel
        (r"_(qkv|fc1)_bias$", P("model")),
        (r"_(proj|fc2)_weight$", P(None, "model")),  # row parallel
        (r"_(proj|fc2)_bias$", P()),
        (r"tok_embed_weight$", P(None, "model")),    # hidden-dim split
        (r"pos_embed_weight$", P()),
        (r"lm_head_weight$", P("model", None)),      # vocab parallel
        (r"lm_head_bias$", P("model")),
        (r"(_ln\d*|ln_f)_(gamma|beta)$", P()),
        (r"_(gamma|beta)$", P()),                    # any other norm
    ], fallback=P(), name="transformer_megatron")


PRESETS = {
    "replicated": _replicated,
    "data_parallel": _replicated,
    "resnet": _resnet,
    "transformer_megatron": _transformer_megatron,
}


def get_preset(name: str) -> PartitionRules:
    try:
        return PRESETS[name]()
    except KeyError:
        raise MXNetError(
            "unknown partition-rule preset %r (have: %s)"
            % (name, ", ".join(sorted(PRESETS))))
