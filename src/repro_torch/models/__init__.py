"""Model substrate: embedding lookups for recommendation models."""
