"""The benchmark's plain reference (exact L2 top-k), independent of the
program under test."""
