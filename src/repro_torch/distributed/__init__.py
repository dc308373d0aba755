"""Distribution: the activation-sharding context of the language-model
zoo (:mod:`.ctx`), and for the SNN the serving mesh (:mod:`.sharding`),
the pipeline-stage runner (:mod:`.pipeline`) and int8 gradient
compression (:mod:`.compression`), ported from ``repro/distributed``.

The reference package's other exports (the ``partition_params`` rule
table, ``act_pspec`` and the other language-model sharding names) are
not ported yet; import the SNN pieces from their modules.
"""

from .ctx import activation_constraints, constrain_acts, constrain_logits

__all__ = ["activation_constraints", "constrain_acts", "constrain_logits"]
