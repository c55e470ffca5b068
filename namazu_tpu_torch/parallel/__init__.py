"""The island step (one island on one card)."""
