"""idle_share.resident: the card's idle share, resident stacks (readers.idle_share)."""

from h100_bench.readers import idle_share as read  # noqa: F401
