"""idle_share.host: the card's idle share, the host stream (readers.idle_share)."""

from h100_bench.readers import idle_share as read  # noqa: F401
