"""The harness: the manifest, the runner, the inputs and the profiler walk."""
