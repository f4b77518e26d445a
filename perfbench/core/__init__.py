"""The harness's general parts: the manifest, seeds, weights, tokens, the
profiler's reduction, the yardstick's arithmetic and the run."""
