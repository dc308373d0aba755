"""Distribution: the activation-sharding context of the language-model
zoo (:mod:`.ctx`) and its sharding rule table (:mod:`.sharding`), and for
the SNN the serving mesh (:mod:`.sharding`), the pipeline-stage runner
(:mod:`.pipeline`) and int8 gradient compression (:mod:`.compression`),
ported from ``repro/distributed``.
"""

from .ctx import activation_constraints, constrain_acts, constrain_logits
from .sharding import (
    act_pspec,
    decode_state_specs,
    dp_axes,
    logits_pspec,
    named_tree,
    partition_params,
    train_batch_spec,
)

__all__ = [
    "activation_constraints", "constrain_acts", "constrain_logits",
    "act_pspec", "decode_state_specs", "dp_axes", "logits_pspec",
    "named_tree", "partition_params", "train_batch_spec",
]
