"""Host spans around the calls into the program's layers, put in place at
run time by the benchmark (the program holds no spans of its own).

A per-layer metric module names the calls it times in `SPANS`: tuples of
(span name, module, attribute path, kind), kind "call" for a function or
method, "iter" for a class or function whose result is iterated (each
step of the iteration is timed). A span's total is its self time: the
time of spans opened inside it is left out.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

Spec = Tuple[str, str, str, str]


class Spans:
    """Self time of each named span while `active`; with `annotate`, each
    span is also a profiler annotation of the same name."""

    def __init__(self, annotate: bool = False):
        self.active = False
        self.annotate = annotate
        self.totals: Dict[str, float] = defaultdict(float)
        self._stack: List[float] = []
        self._undo: List[Tuple[object, str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        note = (torch.profiler.record_function(name) if self.annotate
                else contextlib.nullcontext())
        self._stack.append(0.0)
        t0 = time.perf_counter()
        try:
            with note:
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt - self._stack.pop()
            if self._stack:
                self._stack[-1] += dt

    def install(self, specs: Iterable[Spec]) -> None:
        """Wrap each named call (each (module, attribute) once)."""
        done = set()
        for name, module, path, kind in specs:
            if (module, path) in done:
                continue
            done.add((module, path))
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            orig = getattr(owner, attr)
            wrap = (self._wrap_iter if kind == "iter"
                    else self._wrap_call)(name, orig)
            self._undo.append((owner, attr, orig))
            setattr(owner, attr, wrap)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def _wrap_call(self, name: str, orig):
        def wrapped(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)
        return wrapped

    def _wrap_iter(self, name: str, orig):
        spans = self

        class Timed:
            def __init__(self, *args, **kwargs):
                self._inner = orig(*args, **kwargs)

            def __iter__(self):
                it = iter(self._inner)
                while True:
                    with spans.span(name):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item

        return Timed
