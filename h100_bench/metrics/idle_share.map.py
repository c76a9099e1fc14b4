"""idle_share.map: the card's idle share, texture maps (readers.idle_share)."""

from h100_bench.readers import idle_share as read  # noqa: F401
