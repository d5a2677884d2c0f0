"""Which parameters a tensor-parallel serving engine splits, and how.

Counterpart of mxnet_tpu/parallel/rules.py `megatron_dense_rules` and
`serving_tp_rules`, as the port's own copy of the name classifiers. The
reference maps each parameter path to a PartitionSpec; here a rule gives
a split kind, because the port slices tensors itself (parallel/tp.py):

  * "col": split on axis 0, the out axis (query/key/value and fc1
    weights and their biases: column-parallel);
  * "row": split on axis 1, the in axis (proj and fc2 weights:
    row-parallel; their biases stay whole and are added once, after the
    reduction);
  * "replicated": every shard holds the whole tensor (embeddings and
    the tied LM head, LayerNorms, row-parallel biases, anything
    unmatched).

First match wins, in the reference's order: embeddings replicated
first, then the column weights, the row weights, the column biases.
"""
from __future__ import annotations

import re

__all__ = ["COL_WEIGHT_PATTERN", "ROW_WEIGHT_PATTERN", "COL_BIAS_PATTERN",
           "EMBED_PATTERN", "megatron_kind", "serving_tp_rules",
           "split_kind"]

COL_WEIGHT_PATTERN = (r"(query|key|value|qkv|attn_in|ffn?_?1|intermediate"
                      r"|fc1)\.weight$")
ROW_WEIGHT_PATTERN = (r"(proj|attn_out|out_proj|ffn?_?2|output|fc2)"
                      r"\.weight$")
COL_BIAS_PATTERN = (r"(query|key|value|qkv|attn_in|ffn?_?1|intermediate"
                    r"|fc1)\.bias$")
EMBED_PATTERN = r"embed\w*\.weight$"
_COL_WEIGHT_RE = re.compile(COL_WEIGHT_PATTERN)
_ROW_WEIGHT_RE = re.compile(ROW_WEIGHT_PATTERN)


def megatron_kind(name):
    """'col' / 'row' / None for a parameter path under the megatron dense
    split (first match wins, column first, as the rules)."""
    if _COL_WEIGHT_RE.search(name):
        return "col"
    if _ROW_WEIGHT_RE.search(name):
        return "row"
    return None


def serving_tp_rules():
    """The serving split as an ordered [(compiled regex, kind)] list."""
    return [(re.compile(EMBED_PATTERN), "replicated"),
            (_COL_WEIGHT_RE, "col"),
            (_ROW_WEIGHT_RE, "row"),
            (re.compile(COL_BIAS_PATTERN), "col")]


_RULES = serving_tp_rules()


def split_kind(name):
    """The split kind of parameter path `name` under serving_tp_rules:
    'col', 'row' or 'replicated'."""
    for pat, kind in _RULES:
        if pat.search(name):
            return kind
    return "replicated"
