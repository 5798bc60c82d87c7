"""The plain reference that decides ``correct``: ``plain/`` (a frozen copy
of the port's plain PyTorch path), ``build.py`` (grid, solver settings and
states from a configuration file) and ``compare.py`` (the numbers
compared). Nothing here imports the port."""
