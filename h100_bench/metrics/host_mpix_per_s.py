"""host_mpix_per_s: features-4096-host's input megapixels a second over
the traced run's window (readers.mpix_per_s). Per layer, not end to end:
the host stream is bound by host memory copies, whose rate the host's
neighbours move by more than any bound the benchmark may set."""

from h100_bench.readers import mpix_per_s as read  # noqa: F401
