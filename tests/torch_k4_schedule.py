"""K4's search schedule (``semantic_depth_tpu_torch/csrc/exact_knn.cu``) in
plain torch: the near-first walk of each warp of 64 queries over the
preparation kernel's boxes, its four skip tests with the kernel's margin
(the group test made for 32 groups at a time, after the own group),
the deferral of queries whose k-th distance stays far above their warp's,
and the deferred queries' walk with the 32 lanes over the candidates (for
k > 32: the large-k kernels' far walk, which searches every group again
from the near walk's k-th distance as an inclusive bound and lowers it to
the warp's merged k-th after each group).

``emulate`` repeats the kernel's decisions in the kernel's float32 steps
(each skip test rounds as the kernel's ``__fmul_rn`` / ``__fadd_rn``), so it
returns the kernel's result and the kernel's own counts (``exact_knn.STATS``).
``road_clouds`` makes the exact mode's kind of input. It imports no JAX: the
CPU tests and the card tests both use it."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from semantic_depth_tpu_torch import camera, config
from semantic_depth_tpu_torch.ops import exact_knn as ek
from semantic_depth_tpu_torch.ops import pcl
from semantic_depth_tpu_torch.utils.bench_scenes import scene_pool

INF = float("inf")
_MS = torch.tensor(ek.MARGIN_SQ, dtype=torch.float32)
_MT = torch.tensor(1.0 + ek.MARGIN_THR, dtype=torch.float32)
_ZERO = torch.zeros((), dtype=torch.float32)


def road_clouds(n=2, h=128, w=256, capacity=4096, device="cpu"):
    """(n, capacity) compacted road clouds of analytic scenes in image order
    (road points beyond z_keep_beyond, compacted slab-aware around the
    measuring depth), the exact mode's K4 input; at 128x256 and 4096 slots a
    frame spans four 1024-candidate groups."""
    cfg = config.munich_pipeline_config(input_height=h, input_width=w)
    imgs, labels, disp_norm = scene_pool(n, h, w, seed=0)[:3]
    disp = torch.from_numpy(disp_norm * np.float32(2048.0 * w / 512.0)).to(device)
    cloud = pcl.from_dense(camera.reproject_disparity(disp, cfg.camera),
                           torch.from_numpy(imgs.astype(np.float32)).to(device),
                           torch.from_numpy(labels == 7).to(device))
    cloud = pcl.keep_beyond(cloud, 2, cfg.road.z_keep_beyond)
    depth_rw = cfg.depth - cfg.rw_depth_offset
    packed, _ = pcl.compact_slab_aware(cloud, capacity, 2, -(depth_rw + 0.5), -(depth_rw - 0.5))
    return packed.xyz.contiguous(), packed.valid.contiguous()


def near_first(n: int, start: int, first: int = 1) -> np.ndarray:
    """start, start + first, start - first, start + 2 first, ... within [0, n)."""
    d = np.arange(1, 2 * n + 1) // 2
    seq = start + np.where(np.arange(2 * n) % 2 == 1, first, -first) * d
    seq = np.concatenate([[start], seq[1:]])
    return seq[(seq >= 0) & (seq < n)]


def groups(s: int, warp: int) -> np.ndarray:
    """The groups in the order warp ``warp`` visits them: its own, then the
    others nearest first, the side its own subtile leans to first."""
    own = warp * ek.WARP_QUERIES // ek.SUBTILE
    g0, r0 = divmod(own, ek.GROUP)
    return near_first(-(-s // ek.GROUP), g0, 1 if r0 >= ek.GROUP // 2 else -1)


def walk(s: int, warp: int, skip: bool = True) -> np.ndarray:
    """The subtiles in the order warp ``warp`` visits them: ``groups``, its
    own outward from its own subtile, each other from the side facing its
    own; with ``skip`` off, every subtile in row order."""
    if not skip:
        return np.arange(s)
    own = warp * ek.WARP_QUERIES // ek.SUBTILE
    g0, r0 = divmod(own, ek.GROUP)
    parts = []
    for g in groups(s, warp):
        base = g * ek.GROUP
        n_in = min(ek.GROUP, s - base)
        if g == g0:
            parts.append(base + near_first(n_in, r0))
        elif g > g0:
            parts.append(base + np.arange(n_in))
        else:
            parts.append(base + np.arange(n_in)[::-1])
    return np.concatenate(parts)


def gap2(lo_a, hi_a, lo_b, hi_b):
    """The kernel's squared gap between two boxes (a point is lo == hi): per
    axis fmaxf(fmaxf(lo_b - hi_a, lo_a - hi_b), 0), squares summed x, y, z."""
    d = torch.fmax(torch.fmax(lo_b - hi_a, lo_a - hi_b), _ZERO)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _lane_t(buf, a):
    """Per query: thr * (1 + MARGIN_THR) + MARGIN_SQ |q|^2."""
    return buf[..., -1] * _MT + a


def _tmax(buf, a, live):
    """The warp's largest lane threshold (nan as +inf) over ``live`` lanes."""
    t = _lane_t(buf, a)
    t = torch.where(t <= INF, t, INF)
    return torch.where(live, t, -INF).amax(-1)


def _qbox(q, live):
    """The box of the live lanes' queries (a nan coordinate left out)."""
    ok = live[..., None] & ~q.isnan()
    return torch.where(ok, q, INF).amin(-2), torch.where(ok, q, -INF).amax(-2)


def _boxes(boxes, f, idx, n):
    """boxes[f, idx] for (rows, 32) indices, an index past ``n`` empty."""
    out = boxes[f[:, None], idx.clamp(max=n - 1)]
    past = (idx >= n)[..., None]
    return torch.where(past, torch.tensor([INF, 0, 0, 0, -INF, 0, 0, 0]), out)


def _merge(buf, vals):
    return torch.sort(torch.cat([buf, vals], -1), -1).values[..., :buf.shape[-1]]


def _finish(buf):
    """The kernel's mean over a sorted buffer: the finite roots summed in
    ascending order (float64 roots round like __fsqrt_rn), over their count."""
    fin = torch.isfinite(buf)
    roots = torch.where(fin, torch.sqrt(buf.double()).float(), 0.0)
    acc = torch.zeros(buf.shape[:-1])
    for j in range(buf.shape[-1]):
        acc = acc + roots[..., j]
    return acc / torch.clamp_min(fin.sum(-1).float(), 1.0)


def emulate(xyz: torch.Tensor, valid: torch.Tensor, k: int, skip: bool = True):
    """(B, C, 3) float32, (B, C) bool -> ((B, C) mean distances, the counts
    of ``exact_knn.STATS``), as the kernels compute them."""
    b, c = valid.shape
    s, cp, g_n = ek._sizes(c)
    sub, grp = ek.subtile_boxes(xyz, valid)
    x = F.pad(xyz.float(), (0, 0, 0, cp - c))
    v = F.pad(valid, (0, cp - c))
    cand = torch.where(v[..., None], x, 0.0)
    cx, cy, cz = cand.unbind(-1)
    cw = torch.where(v, (cx * cx + cy * cy) + cz * cz, INF)  # the staged |c|^2
    n_w = -(-cp // ek.WARP_QUERIES)
    rows = torch.arange(n_w * ek.WARP_QUERIES).reshape(n_w, ek.WARP_QUERIES)
    act_all = torch.where(rows < c, F.pad(v, (0, n_w * ek.WARP_QUERIES - cp))[:, rows], False)
    stats = dict.fromkeys(ek.STATS, 0)
    out = torch.full((b, c), INF)
    wf, ww = act_all.any(-1).nonzero(as_tuple=True)
    nw = wf.numel()
    if nw == 0:
        return out, stats
    qrows = rows[ww]
    act = act_all[wf, ww]
    q = torch.where(act[..., None], cand[wf[:, None], qrows.clamp(max=cp - 1)], 0.0)
    qsq = torch.where(act, cw[wf[:, None], qrows.clamp(max=cp - 1)], INF)
    a = qsq * _MS
    orders = torch.from_numpy(np.stack([walk(s, int(w), skip) for w in ww]))
    gseq = F.pad(torch.from_numpy(np.stack([groups(s, int(w)) for w in ww])), (0, ek.SUBTILE),
                 value=g_n)  # past the last: no group
    g0 = orders[:, 0] // ek.GROUP
    pos = torch.full((nw,), -1)  # the warp's position in ``gseq``
    gmark = torch.zeros((nw, ek.SUBTILE), dtype=torch.bool)  # a round of group tests
    buf = torch.full((nw, ek.WARP_QUERIES, k), INF)
    live = act.clone()
    b1 = torch.full((nw, ek.WARP_QUERIES, k), INF)
    deferred = torch.zeros_like(act)
    moved = torch.zeros(nw, dtype=torch.bool)  # past the own group
    qlo, qhi = _qbox(q, live)
    prev = torch.full((nw,), -1)
    gskip = torch.zeros(nw, dtype=torch.bool)
    smask = torch.zeros((nw, ek.GROUP), dtype=torch.bool)
    lanes = torch.arange(ek.SUBTILE)
    for i in range(s):
        sid = orders[:, i]
        g = sid // ek.GROUP
        entry = g != prev
        prev = g
        if skip:
            tr = (entry & (g != g0) & ~moved).nonzero()[:, 0]
            moved[tr] = True
            if tr.numel():  # leaving the own group: defer the far queries
                e = ((buf[tr, :, -1].view(torch.int32) >> 23) & 0xFF).long()
                n = act[tr].sum(-1, keepdim=True)
                tot = torch.where(act[tr], e, 0).sum(-1, keepdim=True)
                dfr = act[tr] & (e * n > tot + ek.DEFER_EXP * n)
                deferred[tr] = dfr
                live[tr] = act[tr] & ~dfr
                b1[tr] = torch.where(dfr[..., None], buf[tr], INF)
                qlo[tr], qhi[tr] = _qbox(q[tr], live[tr])
        on = live.any(-1)
        pos += entry.long()
        if skip:  # a. at positions 1, 33, ...: the next 32 groups against tmax
            rw = (entry & on & (pos >= 1) & ((pos - 1) % ek.SUBTILE == 0)).nonzero()[:, 0]
            if rw.numel():
                tmax = _tmax(buf[rw], a[rw], live[rw])
                gi = gseq[rw[:, None], pos[rw, None] + lanes]
                gb = _boxes(grp, wf[rw], gi, g_n)
                gmark[rw] = ~(gb[..., 0] > gb[..., 4]) & ~(
                    gap2(qlo[rw, None], qhi[rw, None], gb[..., :3], gb[..., 4:7])
                    > tmax[:, None] + gb[..., 3] * _MS)
        ew = (entry & on).nonzero()[:, 0]
        if ew.numel():
            f, gg = wf[ew], g[ew]
            tmax = _tmax(buf[ew], a[ew], live[ew])
            sb = _boxes(sub, f, gg[:, None] * ek.GROUP + lanes, s)
            if skip:
                gskip[ew] = (pos[ew] >= 1) & ~gmark[ew, (pos[ew] - 1) % ek.SUBTILE]
                smask[ew] = ~(sb[..., 0] > sb[..., 4]) & ~(
                    gap2(qlo[ew, None], qhi[ew, None], sb[..., :3], sb[..., 4:7])
                    > tmax[:, None] + sb[..., 3] * _MS)
            else:
                gskip[ew] = False
                smask[ew] = True
        r = sid % ek.GROUP
        wsel = (on & ~gskip & smask[torch.arange(nw), r]).nonzero()[:, 0]
        if wsel.numel() == 0:
            continue
        f, ss = wf[wsel], sid[wsel]
        if skip:
            box = sub[f, ss]
            stats["subtile_tests"] += wsel.numel()
            lb = gap2(q[wsel], q[wsel], box[:, None, :3], box[:, None, 4:7])
            t = _lane_t(buf[wsel], a[wsel]) + (box[:, 3] * _MS)[:, None]
            wsel = wsel[(live[wsel] & ~(lb > t)).any(-1)]
            if wsel.numel() == 0:
                continue
            f, ss = wf[wsel], sid[wsel]
        stats["subtiles_loaded"] += wsel.numel()
        idx = ss[:, None] * ek.SUBTILE + lanes
        c4 = cand[f[:, None], idx]
        w4 = cw[f[:, None], idx]
        if skip:
            tmax = _tmax(buf[wsel], a[wsel], live[wsel])
            keep = (w4 < INF) & ~(gap2(qlo[wsel, None], qhi[wsel, None], c4, c4)
                                  > tmax[:, None] + w4 * _MS)
        else:
            keep = torch.ones_like(w4, dtype=torch.bool)
        stats["pairs_near"] += int(keep.sum()) * ek.WARP_QUERIES
        qq = q[wsel]
        cross = (qq[..., 0:1] * c4[:, None, :, 0] + qq[..., 1:2] * c4[:, None, :, 1]
                 + qq[..., 2:3] * c4[:, None, :, 2])
        d2 = (qsq[wsel][..., None] + w4[:, None]) - 2.0 * cross
        take = keep[:, None] & live[wsel][..., None] & (d2 < buf[wsel][..., -1:])
        buf[wsel] = _merge(buf[wsel], torch.where(take, torch.clamp_min(d2, 0.0), INF))
    for j in live.nonzero().tolist():
        out[wf[j[0]], qrows[j[0], j[1]]] = _finish(buf[j[0], j[1]])
    di = deferred.nonzero()
    stats["deferred"] = di.shape[0]
    if di.shape[0]:
        dw, dl = di.unbind(-1)
        if k > ek.REGISTER_MAX_K:
            res, stats["pairs_far"] = _far_walk_large(
                q[dw, dl], qsq[dw, dl], a[dw, dl], b1[dw, dl, -1], wf[dw], sub, grp, cand, cw, s, k)
        else:
            res, stats["pairs_far"] = _far_walk(
                q[dw, dl], qsq[dw, dl], a[dw, dl], b1[dw, dl], wf[dw], g0[dw], sub, grp, cand, cw,
                s)
        out[wf[dw], qrows[dw, dl]] = res
    return out, stats


def _far_walk(q, qsq, a, b1, f, g0, sub, grp, cand, cw, s):
    """The deferred queries' kernel: one warp a query, lane l holding every
    scanned subtile's candidate l in its own k-deep buffer (lanes l < k
    start with the near walk's l-th value), groups tested 32 at a time and
    subtiles 32 at a time against the running bound T (the near walk's k-th
    value, lowered after each group to the lanes' smallest k-th),
    the own group left out; the merged k smallest of the lanes' buffers."""
    d, k = b1.shape
    g_n = grp.shape[1]
    lb = torch.full((d, ek.SUBTILE, k), INF)
    lb[:, :k, 0] = b1[:, :k]
    t_b = b1[:, -1].clone()
    pairs = 0
    lanes = torch.arange(ek.SUBTILE)
    qlo = q[:, None]
    for r0 in range(0, g_n, ek.SUBTILE):
        gi = r0 + lanes
        gb = _boxes(grp, f, gi.expand(d, -1), g_n)
        tg = (t_b * _MT + a)[:, None] + gb[..., 3] * _MS
        need_g = ((gi[None] != g0[:, None]) & ~(gb[..., 0] > gb[..., 4])
                  & ~(gap2(qlo, qlo, gb[..., :3], gb[..., 4:7]) > tg))
        for j in range(min(ek.SUBTILE, g_n - r0)):
            gsel = need_g[:, j].nonzero()[:, 0]
            if gsel.numel() == 0:
                continue
            base = (r0 + j) * ek.GROUP
            sb = _boxes(sub, f[gsel], (base + lanes).expand(gsel.numel(), -1), s)
            ts = (t_b[gsel] * _MT + a[gsel])[:, None] + sb[..., 3] * _MS
            need_s = ~(sb[..., 0] > sb[..., 4]) & ~(gap2(qlo[gsel], qlo[gsel], sb[..., :3],
                                                         sb[..., 4:7]) > ts)
            for m in range(ek.GROUP):
                ssel = gsel[need_s[:, m]]
                if ssel.numel() == 0:
                    continue
                pairs += ssel.numel() * ek.SUBTILE
                idx = (base + m) * ek.SUBTILE + lanes
                c4 = cand[f[ssel][:, None], idx]
                w4 = cw[f[ssel][:, None], idx]
                qq = q[ssel]
                cross = ((qq[:, 0:1] * c4[..., 0] + qq[:, 1:2] * c4[..., 1])
                         + qq[:, 2:3] * c4[..., 2])
                d2 = (qsq[ssel][:, None] + w4) - 2.0 * cross
                take = d2 < torch.minimum(lb[ssel, :, -1], t_b[ssel, None])
                new = torch.where(take, torch.clamp_min(d2, 0.0), INF)
                lb[ssel] = _merge(lb[ssel], new[..., None])
            t_b[gsel] = torch.minimum(t_b[gsel], lb[gsel, :, -1].amin(-1))
    best = torch.sort(lb.reshape(d, -1), -1).values[:, :k]
    return _finish(best), pairs


def _far_walk_large(q, qsq, a, thr, f, sub, grp, cand, cw, s, k):
    """The large-k far walk: one warp a deferred query over every group
    (its own included), groups tested 32 at a time against the bound at the
    round's start, a needed group's subtiles against the current bound, each
    needed subtile's candidates with d2 <= bound kept; the bound starts at
    the near walk's k-th distance (at most the largest float) and after each
    needed group drops to the k-th of all kept so far. The mean of the
    finite k smallest kept."""
    d = q.shape[0]
    g_n = grp.shape[1]
    buf = torch.full((d, k), INF)
    lim = torch.minimum(thr, torch.tensor(torch.finfo(torch.float32).max))
    pairs = 0
    lanes = torch.arange(ek.SUBTILE)
    qlo = q[:, None]
    for r0 in range(0, g_n, ek.SUBTILE):
        gi = r0 + lanes
        gb = _boxes(grp, f, gi.expand(d, -1), g_n)
        tg = (lim * _MT + a)[:, None] + gb[..., 3] * _MS
        need_g = ~(gb[..., 0] > gb[..., 4]) & ~(gap2(qlo, qlo, gb[..., :3], gb[..., 4:7]) > tg)
        for j in range(min(ek.SUBTILE, g_n - r0)):
            gsel = need_g[:, j].nonzero()[:, 0]
            if gsel.numel() == 0:
                continue
            base = (r0 + j) * ek.GROUP
            sb = _boxes(sub, f[gsel], (base + lanes).expand(gsel.numel(), -1), s)
            ts = (lim[gsel] * _MT + a[gsel])[:, None] + sb[..., 3] * _MS
            need_s = ~(sb[..., 0] > sb[..., 4]) & ~(gap2(qlo[gsel], qlo[gsel], sb[..., :3],
                                                         sb[..., 4:7]) > ts)
            for m in range(ek.GROUP):
                ssel = gsel[need_s[:, m]]
                if ssel.numel() == 0:
                    continue
                pairs += ssel.numel() * ek.SUBTILE
                idx = (base + m) * ek.SUBTILE + lanes
                c4 = cand[f[ssel][:, None], idx]
                w4 = cw[f[ssel][:, None], idx]
                qq = q[ssel]
                cross = ((qq[:, 0:1] * c4[..., 0] + qq[:, 1:2] * c4[..., 1])
                         + qq[:, 2:3] * c4[..., 2])
                d2 = (qsq[ssel][:, None] + w4) - 2.0 * cross
                new = torch.where(d2 <= lim[ssel, None], torch.clamp_min(d2, 0.0), INF)
                buf[ssel] = _merge(buf[ssel], new)
            lim[gsel] = torch.minimum(lim[gsel], buf[gsel, -1])
    return _finish(buf), pairs
