"""Distribution for the SNN: the serving mesh (:mod:`.sharding`), the
pipeline-stage runner (:mod:`.pipeline`) and int8 gradient compression
(:mod:`.compression`), ported from ``repro/distributed``.

The reference package's exports (``activation_constraints``, the
``partition_params`` rule table and the other language-model sharding
names) serve only the model zoo, which is not ported yet; import the SNN
pieces from their modules.
"""

__all__: list = []
