"""Model blocks and assembly for the ported slice."""
