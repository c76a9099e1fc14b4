"""idle_share.serve: the card's idle share, the served open loop (readers.idle_share)."""

from h100_bench.readers import idle_share as read  # noqa: F401
