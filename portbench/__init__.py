"""The benchmark of ``gansynth_tpu_torch`` on an NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` in a new process and
prints one JSON line. Everything that belongs to one configuration, cell,
driver or per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``. ``count/`` holds the
operation counts and the card's peaks, ``reference/`` the plain reference
that decides ``correct``. Nothing here imports JAX or ``gansynth_tpu``;
``reference/`` imports nothing of ``gansynth_tpu_torch`` either.
"""
