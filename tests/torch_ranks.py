"""One rank of the port's ``DistributedDecoder``: the target of the
processes that ``tests/test_torch_hosts.py`` spawns.  It imports torch and
the port only, so that each process starts without JAX."""


def decode_rank(rank, world, port, data, init, q):
    """Join a ``gloo`` world of ``world`` ranks (rank 0's store on
    ``127.0.0.1:port``; ``init`` "tcp" passes the three values,
    "env" sets the ``torchrun`` variables and passes none), decode this
    rank's chunks of ``data`` on the CPU and put ``(rank, world size, mesh
    shape, chunk indices, results)`` on ``q``, or ``(rank, "error",
    message, None, None)``."""
    import os
    try:
        import torch
        import torch.distributed as dist
        from tiny_mp2v_dec_tpu_torch import DecoderConfig
        from tiny_mp2v_dec_tpu_torch.parallel.distributed import (
            DistributedDecoder, host_chip_mesh, init_distributed)
        torch.set_num_threads(1)
        if init == "env":
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                              WORLD_SIZE=str(world), RANK=str(rank))
            init_distributed()
        else:
            init_distributed(f"127.0.0.1:{port}", world, rank)
        mesh = host_chip_mesh(device="cpu")
        dd = DistributedDecoder(DecoderConfig(device="cpu"))
        res = dd.decode(data)
        q.put((rank, dist.get_world_size(), mesh.shape,
               [c.index for c in dd.my_chunks(data)], res))
        dist.destroy_process_group()
    except Exception as e:  # surface the failure in the parent
        q.put((rank, "error", repr(e), None, None))
