"""Shared helpers of the PyTorch port's parity tests (``test_torch_*.py``).

Inputs are made from a seed with numpy and handed to both packages; every
comparison is exact, because all of the decoder's arithmetic is integer.
"""
import os
import sys
import threading
import traceback

import numpy as np
import pytest

from m2v_encoder import encode_stream, random_picture
from tiny_mp2v_dec_tpu import headers as H

# seconds a decode through the port's threads may take before the test
# counts it as a deadlock
WATCHDOG_S = 120.0

# decode-order picture types and temporal references of an IPBPB stream
IPBPB = ((H.PCT_I, 0), (H.PCT_P, 2), (H.PCT_B, 1), (H.PCT_P, 4),
         (H.PCT_B, 3))


def ipb_stream(rng, mb_w, mb_h, cf, pictures=IPBPB, **opts) -> bytes:
    """A random stream with the given (picture type, temporal reference)
    sequence (the recipe of test_pallas_kernels._ipb_stream)."""
    pics = []
    for pct, tr in pictures:
        p = random_picture(rng, mb_w, mb_h, cf, pct, **opts)
        p.temporal_reference = tr
        pics.append(p)
    return encode_stream(mb_w * 16, mb_h * 16, cf, pics)


def assert_frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for i, (a, b) in enumerate(zip(fa, fb)):
        np.testing.assert_array_equal(a.y, b.y, err_msg=f"frame {i} Y")
        np.testing.assert_array_equal(a.u, b.u, err_msg=f"frame {i} U")
        np.testing.assert_array_equal(a.v, b.v, err_msg=f"frame {i} V")


def device_recon_parity(mc_impl, cf, width, height, field, seed,
                        bidir=True):
    """One picture through the port's ``DeviceRecon(mc_impl=...)`` on the
    CPU and through the JAX package's ``DeviceRecon`` on its Pallas path
    (interpret mode; for an explicit roll with field support the JAX
    package turns the kernel off and takes its XLA gather), with the same
    random residual, tokens and reference planes (``random_tokens``, the
    recipe of test_pallas_kernels.py), field prediction on about half the
    inter MBs when ``field``.  Asserts the three planes are equal."""
    import jax
    import jax.numpy as jnp
    import torch

    from tiny_mp2v_dec_tpu.ops.recon import DeviceRecon as JaxRecon
    from tiny_mp2v_dec_tpu.parallel.mesh import random_tokens
    from tiny_mp2v_dec_tpu.tokenizer.types import PictureGeometry as JaxGeom
    from tiny_mp2v_dec_tpu_torch import PictureGeometry
    from tiny_mp2v_dec_tpu_torch.ops.recon import DeviceRecon, pack_meta2

    rng = np.random.default_rng(seed)
    geom = JaxGeom(width=width, height=height, chroma_format=cf)
    n = geom.n_mb
    t = random_tokens(rng, geom)
    t.dct_type[:] = rng.random(n) < 0.3
    if field:
        t.field_pred[:] = ~t.intra & (rng.random(n) < 0.5)
        t.mvfs[:] = rng.integers(0, 2, t.mvfs.shape)
    residual = rng.integers(-300, 300,
                            (n, geom.blocks_per_mb, 8, 8)).astype(np.int16)
    refs = [rng.integers(0, 256, s).astype(np.uint8)
            for s in (geom.luma_padded, geom.chroma_padded,
                      geom.chroma_padded) * 2]
    vecs = [np.ascontiguousarray(v) for v in (
        t.dct_type, t.fwd, t.bwd, t.field_pred, t.coded, t.mv, t.mvfs)]
    jr = JaxRecon(geom, field_support=field, use_pallas_mc=True,
                  use_pallas_idct=False, pallas_interpret=True,
                  mc_impl=mc_impl)
    want = jax.jit(jr._recon_from_residual, static_argnames=("bidir",))(
        jnp.asarray(residual), *map(jnp.asarray, vecs),
        *map(jnp.asarray, refs), bidir=bidir)
    pr = DeviceRecon(PictureGeometry(width=width, height=height,
                                     chroma_format=cf), "cpu",
                     field_support=field, mc_impl=mc_impl)
    assert pr.mc_impl == mc_impl
    # the port takes the tokens as the chunk blob carries them
    got = pr._recon_from_residual(
        torch.from_numpy(residual.reshape(-1, 64)),
        torch.from_numpy(pack_meta2(t, field)),
        *map(torch.from_numpy, refs), bidir=bidir)
    for comp, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"component {comp}")


def watchdog(fn, timeout=WATCHDOG_S):
    """``fn()`` on a daemon thread: its result, or its exception raised
    here (the discipline of test_pipeline_stress._watchdog).  Past
    ``timeout`` seconds the work counts as a deadlock and the test fails,
    with every thread's stack in the message.  The decoder's stuck worker
    threads would then keep the process from ever exiting (at exit
    ``concurrent.futures`` joins its threads), so the process is also set
    to end with status 1 as soon as it starts to exit, before that join:
    a deadlock fails the test and does not hang the suite."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: B036 - re-raised below
            out["error"] = e

    th = threading.Thread(target=run, name="watchdog", daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        frames = sys._current_frames()
        stacks = "".join(
            f"\n--- thread {t.name}\n"
            + "".join(traceback.format_stack(frames[t.ident]))
            for t in threading.enumerate() if t.ident in frames)
        # run before concurrent.futures' own exit hook, which would wait
        # for the stuck workers (these hooks run newest first)
        threading._register_atexit(os._exit, 1)
        pytest.fail(f"deadlock: the work exceeded the {timeout:.0f} s "
                    f"watchdog; the threads:{stacks}")
    if "error" in out:
        raise out["error"]
    return out["value"]
