"""The reference's examples on the port: ``python -m
repro_torch.examples.<name>`` for the SNN's ``quickstart``, ``amc_train``,
``amc_serve``, ``amc_deploy`` and ``snn_pipeline``, and the language-model
zoo's ``lm_pretrain``.

Each keeps its reference's flags and report lines, adds ``--device``
(default: the card; ``cpu`` runs the plain versions on the CPU), and
exposes ``run(args)`` (the numbers it reports, as a dict) beside
``main(argv)``.  Importing one runs nothing.
"""
