"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line.  Everything a cell needs is found by name:
``configs/<config>.json`` (the model's sizes), ``traffic/<traffic>.json``
(the load or the training job), ``limits/<workload>.json`` (the limits
of the correctness comparison) and ``metrics/<metric>.py`` (one reader
per metric).  ``reference/`` is the plain PyTorch model that decides
``correct``; it imports nothing of the port.
"""
