"""The reference's SNN examples on the port: ``python -m
repro_torch.examples.<name>`` for ``quickstart``, ``amc_train``,
``amc_serve``, ``amc_deploy`` and ``snn_pipeline``.

Each keeps its reference's flags and report lines, adds ``--device``
(default: the card; ``cpu`` runs the plain versions on the CPU), and
exposes ``run(args)`` (the numbers it reports, as a dict) beside
``main(argv)``.  Importing one runs nothing.
"""
