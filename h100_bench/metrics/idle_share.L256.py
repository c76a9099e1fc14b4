"""idle_share.L256: the card's idle share, resident stacks at L = 256 (readers.idle_share)."""

from h100_bench.readers import idle_share as read  # noqa: F401
