"""The port's benchmark (``python3 portbench/run.py --workload <cell> ...``).

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``workloads/<cell>.json``,
``metrics/<metric>.py``, ``costs/<kernel>.py`` and
``drivers/<driver>.py``; ``reference/`` is the plain reference that
decides ``correct``.  See ``README.md``.
"""
