"""The plain reference that decides ``correct``.

Written for the benchmark, apart from the program's code: ``farmhash.py``
(FarmHash32 from the published algorithm), ``checksum.py`` (a view's Node
checksum string, built and hashed row by row), ``mix.py`` (the scalable
engine's record hash and ring digest), and the guarantee checks of
``ensemble.py`` and ``storm.py``.  ``frozen/`` is a copy of the port's plain
engine (see its docstring), the regression twin that ``ensemble.py`` and
``storm.py`` also step.  Nothing here imports the program, the JAX package
or JAX (``tests/test_imports.py`` holds it).
"""
