"""One reader a metric, named as ``BENCHMARK.json`` names the metric:
``read(run)`` takes the run's record (``portbench.harness.Run``) and
returns the number, or None where the run holds nothing to read. A reader
of a kernel's roofline names the kernel in ``KERNELS``, so that a traced
run records that kernel's calls."""
