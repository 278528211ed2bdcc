"""One reader per metric, named as the metric in ``BENCHMARK.json``."""
