"""The paper's table and figure scripts, on the port.

One module per table, each with the reference script's ``NAME``,
``run()`` and ``format_table()`` (``benchmarks/<name>.py``), runnable as
``python -m repro_torch.bench.<name>``:

* :mod:`~repro_torch.bench.table1_goap_vs_sw` — Table I, SW vs GOAP
  fetch and accumulation counts (numpy);
* :mod:`~repro_torch.bench.table2_coo_overhead` — Table II, COO storage
  against dense (bit widths);
* :mod:`~repro_torch.bench.table3_accum_ratio` — Table III, accumulation
  ratio against spatial sparsity (the conv stack streamed on a device);
* :mod:`~repro_torch.bench.table45_perf_model` — Tables IV-V, the cycle
  and power models against the paper's measurements;
* :mod:`~repro_torch.bench.accuracy_sweep` — Fig. 8 and Table V accuracy
  (trains the model on a device).

The two that touch tensors take ``--device`` and run on the card unless
it names the CPU.  Beside them, :mod:`~repro_torch.bench.span_cost`
times the serving worker's spans, alone and in a cell of the benchmark.
"""
