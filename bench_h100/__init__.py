"""The H100 benchmark of spmv_torch: one command runs one cell once.

    python bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (the deployment), ``traffic/<traffic>.json`` (the
mix's parameters, read by ``loops/<loop>.py``), ``workloads/<cell>.json``
(the cell's correctness limits), ``matrices/<generator>.py``,
``methods/<method>.py`` and ``metrics/<quantity>.py`` (the reader of each
per-layer metric named ``<quantity>`` or ``<quantity>.<split>``). The
yardstick (the generators, the reference in ``reference/``, ``roofline.py``
and the trace reduction in ``trace.py``) imports nothing of the program.
"""
