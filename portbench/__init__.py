"""The port's benchmark: cells, configurations, traffic mixes and
per-layer metrics named in ``BENCHMARK.json`` at the checkout's root."""
