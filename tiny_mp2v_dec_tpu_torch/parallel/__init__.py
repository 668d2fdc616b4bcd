"""Multi-device and multi-host decode: row-sharded pictures and stream
batches (:mod:`.mesh`), closed GOPs over worker processes (:mod:`.hosts`)
and over ``torch.distributed`` ranks (:mod:`.distributed`)."""
