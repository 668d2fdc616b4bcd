"""Seeded stream generation: a frozen copy of the repository's test encoder
and the one generator every configuration goes through."""
