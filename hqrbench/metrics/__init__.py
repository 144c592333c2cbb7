"""Per-layer readers: ``metrics/<name>.py`` reads the metric ``<name>`` of
``BENCHMARK.json`` from a :class:`hqrbench.trace.TraceView` with
``read(view)``, and returns None where the trace holds nothing to read."""
