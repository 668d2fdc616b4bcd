"""Multi-device decode: row-sharded pictures and stream batches
(:mod:`.mesh`)."""
