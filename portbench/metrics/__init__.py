"""Per-layer metrics, one module a metric, named as in BENCHMARK.json.

A module holds `read(run)`, which returns the metric's value from a
harness.Run (the window's spans and counters, the traced pass), or None
where the run holds nothing to read; and, where it times calls into the
program, `SPANS`: (span name, module, attribute path, "call" | "iter")
tuples, which the harness wraps in the traced run (see spans.py).
"""
