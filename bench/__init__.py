"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything a cell needs is found by name
(``plugins.py``): ``workloads/<cell>.json`` (the pair and the limits of
the correctness check), ``configs/<config>.json`` (the program family,
the model, the graph, the program's settings), ``programs/<family>.py``
(a family's program: its resident inputs, compile, step, reference and
needed work), ``traffic/<mix>.json`` (parameters only),
``traffic/kinds/<kind>.py`` (a mix kind's inputs, drawn by
``traffic/generator.py``), ``traffic/loops/<loop>.py`` (the window),
``reference/models/<model>.py`` (a model's plain reference and needed
work) and ``metrics/<metric>.py`` (one reader per metric).  The plain
reference, the work counts, the peaks and the comparison that decides
``correct`` live in ``reference/`` and import nothing of the program.
"""
