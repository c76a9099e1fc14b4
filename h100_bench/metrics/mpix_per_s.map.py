"""mpix_per_s.map: texture-map-4096's input megapixels a second (readers.mpix_per_s)."""

from h100_bench.readers import mpix_per_s as read  # noqa: F401
