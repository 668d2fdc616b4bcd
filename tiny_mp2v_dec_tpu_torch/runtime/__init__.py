"""Decoder runtime: stream walk, chunking, reordering and delivery."""
