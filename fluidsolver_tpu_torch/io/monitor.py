"""Aligned ascii monitor table: port of ``fluidsolver_tpu.io.monitor``,
format-compatible with the reference's ``Monitor`` (src/Monitor.hpp:11-87):
`| `-separated centered columns, floats as .6e, header written once. For
the same values the file is byte-identical to the JAX package's; parsed by
``io/monitor_parse.py`` and python/Utility.py-style readers."""

from __future__ import annotations

from typing import Callable, List, Union

MIN_LENGTH = 13  # min width for the `.6e` format (src/Monitor.hpp:13)


class Monitor:
    def __init__(self, filename: str):
        self._out = open(filename, "w")
        self._names: List[str] = []
        self._getters: List[Callable[[], Union[float, int]]] = []
        self._lengths: List[int] = []
        self._wrote_header = False

    def add_variable(self, getter: Callable[[], Union[float, int]], name: str):
        """getter: zero-arg callable returning the current value (the
        functional analog of the reference's registered pointers)."""
        self._getters.append(getter)
        self._lengths.append(max(len(name), MIN_LENGTH))
        self._names.append(name)

    def _write_header(self):
        parts = [f"{name:^{length}}" for name, length in zip(self._names, self._lengths)]
        self._out.write("| " + " | ".join(parts) + " | \n")
        self._out.write("|" + "|".join("-" * (length + 2) for length in self._lengths) + "|\n")
        self._wrote_header = True

    def write(self):
        if not self._names:
            return
        if not self._wrote_header:
            self._write_header()
        cols = []
        for getter, length in zip(self._getters, self._lengths):
            v = getter()
            if isinstance(v, (int,)) and not isinstance(v, bool):
                cols.append(f"{v:^{length}}")
            else:
                cols.append(f"{float(v):^{length}.6e}")
        self._out.write("| " + " | ".join(cols) + " | \n")
        self._out.flush()

    def close(self):
        self._out.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
