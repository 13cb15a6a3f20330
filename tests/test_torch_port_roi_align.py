"""Host-side rules of the ROIAlign kernels (``csrc/roi_align.cu``), on the
CPU, and a P = 7 multi-level parity case against the JAX package.

No kernel is built or launched here.  The kernels rest on rules that their
Python mirrors in ``ops/roi_align_windowed.py`` state:

- a roi's taps are separable (``axis_taps``), and its footprint on a level
  (the pixels its taps reach) contains every pixel where autograd of the
  plain pooling gives a nonzero gradient, and exceeds that set by at most
  one pixel a side; the backward's ballot box (``tap_box``) contains it;
- the backward's tile plan (``bwd_tile_rows``) and its walk: tiles of the
  map, the rois whose ballot box meets a tile in roi order, 32 at a time,
  the bins each sends the tile (``sample_range`` of the tile's rows and
  columns), summed by the owner of each pixel in one fixed order.  A loop
  mirror of that walk gives the gradient of the plain pooling;
- the wrappers refuse, with ``ValueError`` and before loading any library,
  what the kernels cannot take.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veto_tpu.ops.roi_align import multilevel_roi_align as j_multilevel

from torch_port_threads import one_torch_thread_per_worker  # noqa: F401

from veto_tpu_torch.ops import cuda_lib
from veto_tpu_torch.ops import roi_align_windowed as rw
from veto_tpu_torch.ops.roi_align import fpn_level_assignment

SCALES = (0.25, 0.125, 0.0625, 0.03125)

# the edge rois of chip_smoke.eval_rois at its 800 x 1344 image: one per
# FPN level, partly off the map, degenerate (< 1 px), a padded zero box,
# the 1:6 roi 60 rows tall on P2, and rois at the last row and column
EDGE_ROIS = np.array([
    [10, 20, 60, 70], [100, 80, 250, 230], [50, 40, 350, 340],
    [10, 5, 900, 780],                            # P2 .. P5
    [-30, -20, 40, 60], [1300, 760, 1400, 860],   # off the map
    [200.2, 100.7, 200.5, 100.9], [0, 0, 0, 0],   # degenerate / padding
    [300, 10, 340, 250],                          # 1:6, 60 rows on P2
    [1200, 700, 1343.5, 799.5], [1340, 795, 1344, 800],  # last row and column
    [1500, 900, 1600, 1000],                      # off the map entirely
], np.float32)


def _random_rois(rng, n, h=800, w=1344):
    x1, y1 = rng.uniform(0, w * 0.7, n), rng.uniform(0, h * 0.7, n)
    x2 = np.minimum(x1 + rng.uniform(w * 0.1, w * 0.3, n), w - 1.0)
    y2 = np.minimum(y1 + rng.uniform(h * 0.1, h * 0.3, n), h - 1.0)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _plain_grad_per_roi(rois, scale, p, s, h, w, seed):
    """Autograd of the plain pooling of each roi alone on an h x w level:
    (R, h, w) f32, one image per roi."""
    rng = np.random.default_rng(seed)
    r = rois.shape[0]
    feat = torch.zeros(r, h, w, 1, requires_grad=True)
    out = rw.multilevel_roi_align_batched(
        [feat], torch.from_numpy(rois)[:, None], (scale,), p, s)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (out * g).sum().backward()
    return feat.grad[..., 0].numpy()


@pytest.mark.parametrize("p", (8, 7))
def test_footprint_contains_the_plain_gradient(p):
    s = 2
    rois = np.concatenate([EDGE_ROIS, _random_rois(np.random.default_rng(p), 8)])
    for scale in SCALES:
        h, w = int(800 * scale), int(1344 * scale)
        grads = _plain_grad_per_roi(rois, scale, p, s, h, w, seed=p)
        for roi, grad in zip(rois, grads):
            fp = rw.footprint(roi, scale, p, s, h, w)
            ys, xs = np.nonzero(grad)
            if fp is None:
                assert ys.size == 0, (roi, scale)
                continue
            (y0, y1), (x0, x1) = fp
            assert ys.size, (roi, scale)
            # contains every nonzero pixel, and no more than one pixel a side
            assert y0 <= ys.min() <= y0 + 1 and y1 - 1 <= ys.max() <= y1, (roi, scale)
            assert x0 <= xs.min() <= x0 + 1 and x1 - 1 <= xs.max() <= x1, (roi, scale)
            (by0, by1), (bx0, bx1) = rw.tap_box(roi, scale, p, s, h, w)
            assert by0 <= y0 and y1 <= by1 and bx0 <= x0 and x1 <= bx1, (roi, scale)


def test_taps_match_the_plain_coordinates():
    """The kernels' separable taps are the plain version's sample
    coordinates and border rules, bit for bit."""
    from veto_tpu_torch.ops.roi_align import _sample_coords

    rois = np.concatenate([EDGE_ROIS, _random_rois(np.random.default_rng(3), 16)])
    for p in (7, 8):
        ys, xs = _sample_coords(torch.from_numpy(rois), 0.0625, p, 2)
        for roi, y, x in zip(rois, ys.numpy(), xs.numpy()):
            for axis, ref in ((1, y), (0, x)):
                start, size = rw.roi_axis(roi, axis, 0.0625, p)
                np.testing.assert_array_equal(
                    rw.sample_coords(start, size, p, 2), ref.reshape(-1))


def _tap_weight(lo, hi, wl, wh, pixel, cell, s):
    """The weight of bin ``cell`` of one axis at ``pixel``: its samples'
    taps on that pixel, in sample order, f32."""
    w = np.float32(0)
    for k in range(cell * s, cell * s + s):
        if lo[k] == pixel:
            w = np.float32(w + wl[k])
        if hi[k] == pixel:
            w = np.float32(w + wh[k])
    return w


def owner_backward(shapes, rois, levels, g, scales, p, s, tile_h):
    """A loop mirror of ``roi_align_bwd_kernel``: per (image, level, tile)
    the ballot on ``tap_box``, the hits in roi order in batches of 32, the
    bins each sends the tile (``sample_range`` of the tile's rows and
    columns), each weighted at each pixel by its separable weight wy x wx,
    and each pixel's sum in the kernel's order (roi, bin row, bin column;
    the staging passes keep it).  Returns the map gradients, NaN where no
    owner wrote."""
    b_n, r_n = rois.shape[:2]
    c = g.shape[-1]
    tw = rw.BWD_TILE_W
    inv = np.float32(1) / np.float32(s * s)
    out = [np.full((b_n, h, w, c), np.nan, np.float32) for h, w in shapes]
    for lvl, (h, w) in enumerate(shapes):
        for b in range(b_n):
            taps = [rw.roi_taps(roi, scales[lvl], p, s, h, w) for roi in rois[b]]
            boxes = [rw.tap_box(roi, scales[lvl], p, s, h, w) for roi in rois[b]]
            for y0 in range(0, h, tile_h):
                for x0 in range(0, w, tw):
                    acc = np.zeros((tile_h, tw, c), np.float32)
                    hits = [r for r in range(r_n) if levels[b, r] == lvl
                            and boxes[r][0][0] < y0 + tile_h and boxes[r][0][1] >= y0
                            and boxes[r][1][0] < x0 + tw and boxes[r][1][1] >= x0]
                    for hb in range(0, len(hits), rw.BWD_CHUNK):
                        for r in hits[hb:hb + rw.BWD_CHUNK]:
                            (ylo, yhi, ywl, ywh), (xlo, xhi, xwl, xwh) = taps[r]
                            ky0, ky1 = rw.sample_range(ylo, yhi, y0, y0 + tile_h)
                            kx0, kx1 = rw.sample_range(xlo, xhi, x0, x0 + tw)
                            if ky0 >= ky1 or kx0 >= kx1:
                                continue
                            for i in range(ky0 // s, (ky1 - 1) // s + 1):
                                wy = np.array([_tap_weight(ylo, yhi, ywl, ywh, y0 + t, i, s)
                                               for t in range(tile_h)], np.float32)
                                for j in range(kx0 // s, (kx1 - 1) // s + 1):
                                    wx = np.array([_tap_weight(xlo, xhi, xwl, xwh, x0 + t, j, s)
                                                   for t in range(tw)], np.float32)
                                    acc += (wy[:, None] * wx[None, :])[..., None] * g[b, r, i, j]
                    rows, cols = min(tile_h, h - y0), min(tw, w - x0)
                    out[lvl][b, y0:y0 + rows, x0:x0 + cols] = acc[:rows, :cols] * inv
    return out


@pytest.mark.parametrize("case", ("depth_p8_40_rois", "two_levels_p7"))
def test_owner_backward_walk_gives_the_plain_gradient(case):
    """The kernel's walk, mirrored, against autograd of the plain pooling in
    f32 (1e-5 and 2e-6 relative: the same terms, each bin's weight summed
    separably, in another order); zero boxes cross a chunk boundary on one
    tile, the edge rois reach the last row and column, and rois assigned
    past the last level take no part."""
    rng = np.random.default_rng(5)
    if case == "depth_p8_40_rois":
        img, scales, p = (160, 272), (0.0625,), 8
        tile_h = rw.bwd_tile_rows(256, torch.bfloat16)
    else:  # rois of 112 px and more go to the second level, of 224 past it
        img, scales, p = (256, 384), (0.125, 0.0625), 7
        tile_h = rw.bwd_tile_rows(256, torch.float32)
    h_img, w_img = img
    edge = EDGE_ROIS * np.float32([w_img / 1344, h_img / 800] * 2)
    rois = np.stack([np.concatenate([edge, _random_rois(rng, 40 - len(edge),
                                                        h_img, w_img)]),
                     _random_rois(rng, 40, h_img, w_img)])
    if case == "depth_p8_40_rois":
        # padding, as the main path pools it: 36 zero boxes pile onto the
        # corner tile, more than one batch of 32 hits
        rois[1, 4:] = 0
    else:  # rois of about 160 px, assigned to the second level
        rois[1, :3] = [[20, 30, 180, 190], [200, 60, 370, 250], [220, 100, 383, 255.5]]
    c, s = 3, 2
    shapes = [(int(h_img * sc), int(w_img * sc)) for sc in scales]
    feats = [torch.zeros(2, h, w, c, requires_grad=True) for h, w in shapes]
    trois = torch.from_numpy(rois)
    out = rw.multilevel_roi_align_batched(feats, trois, scales, p, s)
    g = rng.standard_normal(out.shape).astype(np.float32)
    out.backward(torch.from_numpy(g))
    levels = (np.zeros(rois.shape[:2], np.int64) if len(scales) == 1
              else fpn_level_assignment(trois).numpy())
    # the sum of |terms| at each element: the weights are >= 0, so the
    # gradient of |g|
    mags = [torch.zeros(2, h, w, c, requires_grad=True) for h, w in shapes]
    rw.multilevel_roi_align_batched(mags, trois, scales, p, s).backward(
        torch.from_numpy(np.abs(g)))
    got = owner_backward(shapes, rois, levels, g, scales, p, s, tile_h)
    for lvl, (mine, f, mag) in enumerate(zip(got, feats, mags)):
        assert not np.isnan(mine).any(), "a pixel without an owner"
        assert np.abs(f.grad.numpy()).max() > 0.1, lvl
        # the same f32 products summed in another order: a few ulps of the
        # sum of |terms|, which the corner pixel under the zero boxes takes
        # from thousands of samples (values up to ~10 here)
        tol = 1e-6 + 2.0 ** -20 * mag.grad.numpy()
        diff = np.abs(mine - f.grad.numpy())
        assert (diff <= tol).all(), (lvl, diff.max(), (diff / tol).max())


@pytest.mark.parametrize("channels, dtype, rows", [
    (256, torch.bfloat16, 4), (256, torch.float32, 2), (512, torch.bfloat16, 2),
    (64, torch.bfloat16, 16), (8, torch.bfloat16, 128), (12, torch.bfloat16, 0),
    (1024, torch.bfloat16, 0), (512, torch.float32, 0), (6, torch.float32, 0)])
def test_bwd_tile_rows_mirrors_the_c_formula(channels, dtype, rows):
    """A backward block is 512 threads in slots of channels / 8 (bf16) or
    / 4 (f32) threads, 8 slots a tile row, each slot owning 2 pixels of
    its column.  At the main path's 256 bf16 channels a block owns 4 x 8
    pixels: 143 tiles of the 50 x 84 depth map an image."""
    assert rw.bwd_tile_rows(channels, dtype) == rows
    if (channels, dtype) == (256, torch.bfloat16):
        assert -(-84 // rw.BWD_TILE_W) * -(-50 // rows) == 143


@pytest.fixture
def no_library(monkeypatch):
    """Loading a kernel library fails the test: refusals come first."""
    def library(name):
        raise AssertionError(f"library {name} loaded before the refusal")
    monkeypatch.setattr(cuda_lib, "library", library)


def _misaligned(t):
    """The same values, contiguous, starting 2 bytes past a 16-byte line."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    out = flat[1:t.numel() + 1].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _bad_call(case):
    """(feats, scales, p, s) that the kernels refuse, by case."""
    def maps(c, dtype=torch.bfloat16, n=1):
        return [torch.zeros(2, 8, 8, c, dtype=dtype) for _ in range(n)]

    if case == "bf16_channels_not_8":
        return maps(12), (0.25,), 4, 2
    if case == "f32_channels_not_4":
        return maps(6, torch.float32), (0.25,), 4, 2
    if case == "too_many_channels":
        return maps(1024), (0.25,), 4, 2
    if case == "five_levels":
        return maps(8, n=5), (0.25,) * 5, 4, 2
    if case == "too_many_samples":
        return maps(8), (0.25,), 17, 2
    if case == "sampling_over_4":
        return maps(8), (0.25,), 2, 5
    if case == "misaligned_map":
        return [_misaligned(maps(8)[0])], (0.25,), 4, 2
    raise AssertionError(case)


BAD_CALLS = ("bf16_channels_not_8", "f32_channels_not_4", "too_many_channels",
             "five_levels", "too_many_samples", "sampling_over_4",
             "misaligned_map")


@pytest.mark.parametrize("case", BAD_CALLS)
@pytest.mark.parametrize("which", ("forward", "backward"))
def test_wrappers_refuse_what_the_kernels_cannot_take(no_library, which, case):
    feats, scales, p, s = _bad_call(case)
    rois = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]] * 2)
    with pytest.raises(ValueError):
        if which == "forward":
            rw._launch(feats, rois, scales, p, s)
        else:
            c = feats[0].shape[-1]
            rw._launch_backward(feats, [True] * len(feats), rois,
                                torch.zeros(2, 1, p, p, c), scales, p, s)


@pytest.mark.parametrize("p", (8, 7))
def test_wrappers_take_the_main_path_shapes(no_library, p):
    """P2-P5 and the depth map of 8 x 800x1344 images, 256 bf16 channels,
    80 rois an image pass every check; the raw launch then refuses tensors
    that are not on a card (no plain fallback), before any library load."""
    feats = [torch.empty(8, 800 // k, 1344 // k, 256, dtype=torch.bfloat16,
                         device="meta") for k in (4, 8, 16, 32)]
    rois = torch.empty(8, 80, 4, device="meta")
    for fs, sc in ((feats, SCALES), (feats[2:3], (0.0625,))):
        with pytest.raises(TypeError, match="CUDA"):
            rw._check(fs, rois, p, 2)
    with pytest.raises(TypeError, match="CUDA"):
        rw._launch([torch.zeros(1, 8, 8, 8)], torch.zeros(1, 2, 4), (0.25,), p, 2)


# ------------------------------------------- P = 7 parity with the JAX package
def _pyramid(rng, b=2, img=512, c=8):
    return [rng.standard_normal((b, img // k, img // k, c)).astype(np.float32)
            for k in (4, 8, 16, 32)]


def _parity_rois(rng, b=2):
    base = np.array([
        [10, 20, 60, 70], [100, 80, 250, 230], [50, 40, 350, 340],
        [10, 5, 500, 495], [-30, -20, 40, 60], [470, 480, 560, 590],
        [600, 620, 700, 720], [200.2, 100.7, 200.5, 100.9], [0, 0, 0, 0],
        [300, 10, 340, 250], [480, 500, 511.5, 511.5],
    ], np.float32)
    out = np.stack([base + rng.uniform(-3, 3, base.shape).astype(np.float32)
                    for _ in range(b)])
    out[:, 6:9] = base[6:9]  # no jitter: off the map, < 1 px, padding
    return out


def test_p7_multilevel_forward_and_backward_match_jax_f32():
    """SGCls's box-head pooling (P = 7) over P2-P5: the forward against
    ``veto_tpu.ops.roi_align.multilevel_roi_align`` and the map gradients
    against ``jax.vjp`` of it, f32 at 1e-5 (sums in another order)."""
    rng = np.random.default_rng(7)
    feats, rois = _pyramid(rng), _parity_rois(rng)
    g = rng.standard_normal((2, rois.shape[1], 7, 7, 8)).astype(np.float32)
    tfs = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = rw.multilevel_roi_align_batched(tfs, torch.from_numpy(rois), SCALES, 7, 2)
    out.backward(torch.from_numpy(g))
    for i in range(2):
        ref, vjp = jax.vjp(
            lambda *fs: j_multilevel(list(fs), jnp.asarray(rois[i]), SCALES, 7, 2),
            *[jnp.asarray(f[i]) for f in feats])
        np.testing.assert_allclose(out[i].detach().numpy(), np.asarray(ref),
                                   atol=1e-5, rtol=0)
        for lvl, (t, r) in enumerate(zip(tfs, vjp(jnp.asarray(g[i])))):
            r = np.asarray(r)
            assert np.abs(r).max() > 0.1, lvl  # every level pools something
            np.testing.assert_allclose(t.grad[i].numpy(), r, atol=1e-5, rtol=0,
                                       err_msg=f"image {i} level {lvl}")
