"""Device-mesh sharding of the F/X/B pipeline (port of
``caltech_bifrost_dsp_tpu/parallel/mesh.py``).

The reference scales out with 32 share-nothing pipelines, each owning 192
of 6144 channels; the F->X corner-turn is done by FPGAs and an Ethernet
switch before the data reaches software (lwa352-pipeline.py:164-180).  On
a mesh the corner-turn and the new shardings become collectives:

- axis ``time``: ADC time blocks are sharded; the PFB's (ntap-1)-frame
  overlap is exchanged between neighbouring shards (``ppermute`` halo);
  visibility partial sums over time reduce with ``psum``.
- axis ``chan``: the reference's frequency sharding.  Before the
  correlator the channelizer output is *input*-sharded over this axis, and
  one ``all_to_all`` of the packed bytes performs the F->X corner-turn.

The JAX module expresses this with ``shard_map`` over a ``jax.sharding.
Mesh``.  Here the mesh is **single-controller**: one Python process owns a
``[n_time][n_chan]`` grid of ``torch.device`` s and runs each shard's work
under that shard's CUDA stream; a sharded value (:class:`Sharded`) is a grid
of per-shard tensors laid out by a partition spec; the four collectives
are plain functions on such grids that copy device to device (``copy_``)
with events between the streams.  The device list may name one device
more than once, so a 2x2 mesh runs at full width on one card (shards of an
input are then views, not copies) and a 2x4 mesh runs on the CPU.  A value
that is replicated over a mesh axis is held ONCE per group (a reduced
visibility matrix on the first time shard's device of its chan column, the
gathered VLBI slab on the first chan shard's device of its time row): a
single controller runs every consumer of such a value once per group.

Per-shard kernels follow ``cfg``'s engines: ``corr_engine="pallas_blk"``
runs the gulp correlator :func:`..ops.corr_blk.corr_blk`,
``"pallas_triu"`` :func:`..ops.corr_triu.corr_triu`, ``"xla"`` the plain
correlator; beam products and subselection run the port's one kernel
each.  Each shard owns whole channels, so sharded integers equal the
unsharded step's exactly.  The state is updated IN PLACE, upper tiles
valid, like the unsharded :class:`..models.xengine.XEngineState`.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..config import XEngineConfig
from ..ops import beamform as bf
from ..ops import corr_subsel as cs
from ..ops import correlate as corr
from ..ops import pfb as pfb_ops
from ..ops.corr_blk import corr_blk
from ..ops.corr_triu import corr_triu
from ..ops.correlate import Vis
from ..utils.codec import unpack

AXES = ("time", "chan")


class Mesh:
    """A ``[n_time][n_chan]`` grid of devices, one CUDA stream per shard
    (none for CPU shards).  ``shape`` maps axis name to size, as on a
    ``jax.sharding.Mesh``."""

    axis_names = AXES

    def __init__(self, devices, n_time: int, n_chan: int):
        devices = [torch.device(d) for d in devices]
        if len(devices) != n_time * n_chan:
            raise ValueError(f"{len(devices)} devices for a {n_time}x"
                             f"{n_chan} mesh")
        for d in devices:
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"no kernel or plain version for {d}")
        self.devices = [devices[t * n_chan:(t + 1) * n_chan]
                        for t in range(n_time)]
        self.shape = {"time": n_time, "chan": n_chan}
        self.streams = [[torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in row] for row in self.devices]

    @property
    def n_time(self) -> int:
        return self.shape["time"]

    @property
    def n_chan(self) -> int:
        return self.shape["chan"]

    def coords(self):
        return [(t, c) for t in range(self.n_time)
                for c in range(self.n_chan)]

    @contextlib.contextmanager
    def on(self, t: int, c: int):
        """Run the body as shard (t, c): its device and stream current."""
        stream = self.streams[t][c]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[t][c]), \
                torch.cuda.stream(stream):
            yield

    def _cuda_devices(self):
        seen = []
        for row in self.devices:
            for d in row:
                if d.type == "cuda" and d not in seen:
                    seen.append(d)
        return seen

    def fork(self) -> None:
        """Every shard stream waits for the work queued so far on its
        device's current stream (the caller's)."""
        events = {}
        for d in self._cuda_devices():
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        for t, c in self.coords():
            if self.streams[t][c] is not None:
                self.streams[t][c].wait_event(events[self.devices[t][c]])

    def join(self) -> None:
        """The caller's current stream on each device waits for every
        shard stream of that device."""
        for t, c in self.coords():
            s = self.streams[t][c]
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
                torch.cuda.current_stream(self.devices[t][c]).wait_event(ev)

    def wait(self, dst, srcs) -> None:
        """Shard ``dst``'s stream waits for the work queued on the streams
        of shards ``srcs``."""
        s_dst = self.streams[dst[0]][dst[1]]
        for t, c in srcs:
            s = self.streams[t][c]
            if s is None or s_dst is None or s is s_dst:
                continue
            ev = torch.cuda.Event()
            ev.record(s)
            s_dst.wait_event(ev)

    def fetch(self, x: torch.Tensor, dst) -> torch.Tensor:
        """``x`` (made on another shard's stream, already waited for) for
        use by shard ``dst``: moved to its device if that differs, and
        kept from the allocator until ``dst``'s stream is done with it."""
        stream = self.streams[dst[0]][dst[1]]
        if stream is not None and x.is_cuda:
            x.record_stream(stream)
        return x.to(self.devices[dst[0]][dst[1]])


def make_mesh(n_time: int = 1, n_chan: int | None = None,
              devices=None) -> Mesh:
    """Build a ('time', 'chan') mesh over the given (or all CUDA) devices.

    ``devices`` may name one device several times (``["cuda:0"] * 4``,
    ``["cpu"] * 8``): those shards share it.  Without ``devices`` every
    CUDA device of the host is taken once, and a mesh that needs more
    shards than there are devices raises: nothing is placed silently.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        given = False
    else:
        devices = list(devices)
        given = True
    if n_chan is None:
        if not devices or len(devices) % n_time:
            raise ValueError("device count not divisible by n_time")
        n_chan = len(devices) // n_time
    need = n_time * n_chan
    if len(devices) < need:
        raise ValueError(
            f"a {n_time}x{n_chan} mesh needs {need} devices, "
            f"{len(devices)} "
            + ("were given" if given else "CUDA devices are present; pass "
               "devices= to place several shards on one device"))
    return Mesh(devices[:need], n_time, n_chan)


class Sharded:
    """A tensor laid out over a mesh: ``spec`` names, per tensor axis, the
    mesh axis that splits it (or None); ``shards[t][c]`` is shard (t, c)'s
    block.  Along a mesh axis that ``spec`` does not name the value is
    replicated, and the entries of such a group may be ONE tensor (see
    the module docstring)."""

    def __init__(self, mesh: Mesh, spec, shards):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = shards

    @property
    def shape(self) -> tuple:
        local = self.shards[0][0].shape
        return tuple(n * (self.mesh.shape[a] if a else 1)
                     for n, a in zip(local, self.spec))

    def __getitem__(self, tc) -> torch.Tensor:
        return self.shards[tc[0]][tc[1]]


def _index(mesh: Mesh, spec, shape, t: int, c: int) -> tuple:
    idx = []
    for n, axis in zip(shape, spec):
        if axis is None:
            idx.append(slice(None))
            continue
        parts = mesh.shape[axis]
        if n % parts:
            raise ValueError(f"axis of {n} does not divide over {parts} "
                             f"'{axis}' shards")
        k = t if axis == "time" else c
        idx.append(slice(k * (n // parts), (k + 1) * (n // parts)))
    return tuple(idx)


def shard(mesh: Mesh, x: torch.Tensor, spec) -> Sharded:
    """Lay ``x`` out over ``mesh`` by ``spec`` (one entry per axis of
    ``x``: "time", "chan" or None).  A shard on ``x``'s device is a view
    of ``x``; a shard elsewhere is a copy made on the current streams."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    grid = [[x[_index(mesh, spec, x.shape, t, c)].to(mesh.devices[t][c])
             for c in range(mesh.n_chan)] for t in range(mesh.n_time)]
    return Sharded(mesh, spec, grid)


def unshard(sx: Sharded, device=None) -> torch.Tensor:
    """The global tensor of ``sx`` on ``device`` (default: the device of
    shard (0, 0)), assembled on the current stream.  Call it outside the
    sharded programs, which join their streams before they return."""
    mesh = sx.mesh
    device = torch.device(device) if device is not None \
        else sx.shards[0][0].device
    first = sx.shards[0][0]
    if all(a is None for a in sx.spec):
        return first.to(device)
    out = torch.empty(sx.shape, dtype=first.dtype, device=device)
    for t, c in mesh.coords():
        if ("time" not in sx.spec and t) or ("chan" not in sx.spec and c):
            continue
        out[_index(mesh, sx.spec, out.shape, t, c)].copy_(sx.shards[t][c])
    return out


# -- collectives -------------------------------------------------------------

def psum(mesh: Mesh, parts, axis: str = "time") -> list:
    """Sum ``parts[t][c]`` over 'time'.  Returns one tensor per chan
    column, on the column's first device (made on shard (0, c)'s stream);
    int32 sums are exact in any order.  With one time shard the part
    itself is returned."""
    if axis != "time":
        raise ValueError("psum reduces over 'time'")
    out = []
    for c in range(mesh.n_chan):
        if mesh.n_time == 1:
            out.append(parts[0][c])
            continue
        mesh.wait((0, c), [(t, c) for t in range(1, mesh.n_time)])
        with mesh.on(0, c):
            acc = parts[0][c].clone()
            for t in range(1, mesh.n_time):
                acc.add_(mesh.fetch(parts[t][c], (0, c)))
        out.append(acc)
    return out


def all_to_all(mesh: Mesh, x, split_axis: int, concat_axis: int,
               memory_order=None):
    """Tiled all-to-all over 'chan': shard (t, c) receives block c of
    every (t, c')'s ``split_axis`` and concatenates them along
    ``concat_axis`` in the order of c'.  ``memory_order`` (a permutation
    of the axes) makes the result a permuted view of a buffer that is
    contiguous in that axis order, so a following ``permute(memory_order)``
    costs no second copy.  One chan shard: ``x`` is returned."""
    n = mesh.n_chan
    if n == 1:
        return x
    out = [[None] * n for _ in range(mesh.n_time)]
    for t in range(mesh.n_time):
        row = [(t, k) for k in range(n)]
        for c in range(n):
            mesh.wait((t, c), row)
            with mesh.on(t, c):
                blocks = []
                for k in range(n):
                    src = x[t][k]
                    w = src.shape[split_axis] // n
                    blocks.append(mesh.fetch(
                        src.narrow(split_axis, c * w, w), (t, c)))
                shape = list(blocks[0].shape)
                shape[concat_axis] = sum(b.shape[concat_axis]
                                         for b in blocks)
                if memory_order is None:
                    buf = torch.empty(shape, dtype=blocks[0].dtype,
                                      device=blocks[0].device)
                else:
                    buf = torch.empty([shape[a] for a in memory_order],
                                      dtype=blocks[0].dtype,
                                      device=blocks[0].device)
                    inverse = [memory_order.index(a)
                               for a in range(len(shape))]
                    buf = buf.permute(inverse)
                at = 0
                for b in blocks:
                    buf.narrow(concat_axis, at, b.shape[concat_axis]) \
                        .copy_(b)
                    at += b.shape[concat_axis]
                out[t][c] = buf
    return out


def ppermute_halo(mesh: Mesh, tails, first):
    """Ring shift by one over 'time': shard (t, c) receives shard
    (t - 1, c)'s ``tails`` entry; shard (0, c) takes ``first[c]`` (zeros,
    or the carry of the previous block) in place of the wrap-around."""
    out = []
    for t in range(mesh.n_time):
        row = []
        for c in range(mesh.n_chan):
            if t == 0:
                row.append(first[c])
                continue
            mesh.wait((t, c), [(t - 1, c)])
            with mesh.on(t, c):
                row.append(mesh.fetch(tails[t - 1][c], (t, c)))
        out.append(row)
    return out


def all_gather(mesh: Mesh, x, axis: int) -> list:
    """Tiled all-gather over 'chan' along tensor ``axis``.  Returns one
    tensor per time row, on the row's first device (made on shard
    (t, 0)'s stream).  One chan shard: the shard itself."""
    out = []
    for t in range(mesh.n_time):
        if mesh.n_chan == 1:
            out.append(x[t][0])
            continue
        mesh.wait((t, 0), [(t, c) for c in range(1, mesh.n_chan)])
        with mesh.on(t, 0):
            out.append(torch.cat([mesh.fetch(x[t][c], (t, 0))
                                  for c in range(mesh.n_chan)], dim=axis))
    return out


# -- per-shard engines -----------------------------------------------------------

def _corr_gulp(cfg: XEngineConfig, packed: torch.Tensor) -> Vis:
    """Per-shard correlation of a [ntime, nchan, ninput] block (a strided
    view is fine) honouring ``cfg.corr_engine``; entries j >= i valid.
    Each shard owns whole channels, so the per-channel integers equal the
    unsharded engine's."""
    if cfg.corr_engine == "pallas_blk":
        return corr_blk(packed, "tci")
    if cfg.corr_engine == "pallas_triu":
        return corr_triu(packed, "tci")
    return corr.correlate_gulp(packed)


def _beam_products_shard(cfg: XEngineConfig, packed, gains: bf.BeamGains,
                         want_power: bool = True, want_vlbi: bool = False):
    """Per-shard beam products (both ``cfg.bf_engine`` names run the one
    fused beamformer)."""
    return bf.beamform_products(packed, gains, cfg.ntime_sum, want_power,
                                want_vlbi)


def _subsel_shard(cfg: XEngineConfig, vis: Vis, pairs) -> Vis:
    """Per-shard subselection honouring ``cfg.subsel_engine``.  Malformed
    runtime selections are clamped as on the single-device path: the
    command key validates only the list length."""
    pairs = pairs.clamp(0, cfg.ninput - 1)
    return cs.corr_subsel_engine(vis, pairs, cfg.nchan_sum,
                                 cfg.subsel_engine)


class FxOutputs(NamedTuple):
    vis: Vis | None        # Sharded int32 [nchan, ninput, ninput], dense
    subsel: Vis | None     # Sharded int32 [nchan // nchan_sum, nvis_out]
    bf_power: Sharded | None   # f32 [nbeam//2, nblock_total, nchan, 4]


VIS_SPEC = ("chan", None, None)
PART_SPEC = ("time", "chan", None, None)
SUBSEL_SPEC = ("chan", None)
POWER_SPEC = (None, "time", "chan", None)
VLBI_SPEC = ("time", None, None, None)


def _grid(mesh: Mesh) -> list:
    return [[None] * mesh.n_chan for _ in range(mesh.n_time)]


def _replicated_over_time(mesh: Mesh, spec, column) -> Sharded:
    return Sharded(mesh, spec, [list(column) for _ in range(mesh.n_time)])


def _replicated_over_chan(mesh: Mesh, spec, rows) -> Sharded:
    return Sharded(mesh, spec, [[r] * mesh.n_chan for r in rows])


def _check_chan_shards(cfg: XEngineConfig, mesh: Mesh,
                       inputs: bool = False) -> None:
    n = mesh.n_chan
    if cfg.nchan % n or (inputs and cfg.ninput % n):
        raise ValueError("ninput and nchan must divide the chan axis")
    if (cfg.nchan // n) % cfg.nchan_sum:
        raise ValueError("per-shard channel count must be a multiple of "
                         "nchan_sum (shard-local subsel channel averaging)")


def _shard_gains(mesh: Mesh, gains: bf.BeamGains):
    """Gains chan-sharded; contiguous per shard (the kernel's contract;
    a slice of whole channels of a contiguous plane already is)."""
    planes = [shard(mesh, g, VIS_SPEC) for g in gains]
    return [[bf.BeamGains(*(p[t, c].contiguous() for p in planes))
             for c in range(mesh.n_chan)] for t in range(mesh.n_time)]


def _replicate(mesh: Mesh, x: torch.Tensor):
    return shard(mesh, x, (None,) * x.dim()).shards


def _dump(cfg, mesh, parts_r, parts_i, pairs, want_subsel):
    """The once-per-window tail: psum over 'time', Hermitian mirror,
    subselection, each once per chan column.  Returns per column the
    dense Vis and the subselection (or None)."""
    sum_r = psum(mesh, parts_r)
    sum_i = psum(mesh, parts_i)
    dense, subsel = [], []
    for c in range(mesh.n_chan):
        with mesh.on(0, c):
            vis = corr.mirror_vis(Vis(sum_r[c], sum_i[c]))
            dense.append(vis)
            subsel.append(_subsel_shard(cfg, vis, pairs[0][c])
                          if want_subsel else None)
    return dense, subsel


def _pack_outputs(mesh, dense, subsel, power, vlbi_rows):
    vis = sub = None
    if dense is not None:
        vis = Vis(*(_replicated_over_time(mesh, VIS_SPEC,
                                          [d[k] for d in dense])
                    for k in range(2)))
        if subsel[0] is not None:
            sub = Vis(*(_replicated_over_time(mesh, SUBSEL_SPEC,
                                              [s[k] for s in subsel])
                        for k in range(2)))
    p = Sharded(mesh, POWER_SPEC, power) if power is not None else None
    v = (_replicated_over_chan(mesh, VLBI_SPEC, vlbi_rows)
         if vlbi_rows is not None else None)
    return FxOutputs(vis, sub, p), v


def xengine_sharded_fn(cfg: XEngineConfig, mesh: Mesh):
    """Channel-parallel fused X/B step for post-F packed input: the
    analog of the reference's share-nothing frequency sharding, plus a
    time axis contributing visibility partial sums via ``psum``.

    ``fn(packed, gains, pairs) -> FxOutputs``: packed uint8 [ntime, nchan,
    ninput] sharded [time, chan, -]; gains chan-sharded; outputs
    chan-sharded (power also time-sharded), vis dense.
    """
    _check_chan_shards(cfg, mesh)

    def fn(packed, gains: bf.BeamGains, pairs):
        pk = shard(mesh, packed, ("time", "chan", None))
        g = _shard_gains(mesh, gains)
        prs = _replicate(mesh, pairs)
        mesh.fork()
        pr, pi, power = _grid(mesh), _grid(mesh), _grid(mesh)
        for t, c in mesh.coords():
            with mesh.on(t, c):
                pr[t][c], pi[t][c] = _corr_gulp(cfg, pk[t, c])
                power[t][c], _ = _beam_products_shard(cfg, pk[t, c],
                                                      g[t][c])
        dense, subsel = _dump(cfg, mesh, pr, pi, prs, True)
        mesh.join()
        return _pack_outputs(mesh, dense, subsel, power, None)[0]

    return fn


def zero_sharded_state(cfg: XEngineConfig, mesh: Mesh):
    """Initial accumulator state of the stateful sharded steps: the fast
    accumulator as per-time-shard partials [n_time, nchan, ninput, ninput]
    (spec time, chan) and the slow planes [nchan, ninput, ninput]
    (chan-sharded, one copy per chan column).  Four distinct buffers per
    shard: the steps update them in place."""
    _check_chan_shards(cfg, mesh)
    ncl = cfg.nchan // mesh.n_chan

    def zeros(t, c, lead):
        return torch.zeros(lead + (ncl, cfg.ninput, cfg.ninput),
                           dtype=torch.int32, device=mesh.devices[t][c])

    def fast():
        return Sharded(mesh, PART_SPEC,
                       [[zeros(t, c, (1,)) for c in range(mesh.n_chan)]
                        for t in range(mesh.n_time)])

    def slow():
        return _replicated_over_time(
            mesh, VIS_SPEC, [zeros(0, c, ()) for c in range(mesh.n_chan)])

    return (Vis(fast(), fast()), Vis(slow(), slow()))


def _state_xb_tail(cfg, mesh, state, pk, g, prs, fast_first, fast_last,
                   slow_first, want_power, want_vlbi, want_subsel):
    """Shared tail of the stateful sharded steps, between ``fork`` and
    ``join``.

    The fast accumulator is carried as per-time-shard partial sums, so
    mid-window gulps touch no collective for the visibilities: the
    ``psum`` over 'time' happens once per fast window, at the dump call.
    Subselection likewise only exists at the dump, and the slow
    accumulator is updated from the psum'd full window, once per chan
    column.
    """
    (fr, fi), (sr, si) = state
    power = _grid(mesh) if want_power else None
    vlbi = _grid(mesh) if want_vlbi else None
    for t, c in mesh.coords():
        with mesh.on(t, c):
            part = _corr_gulp(cfg, pk[t][c])
            for acc, new in ((fr[t, c][0], part.real),
                             (fi[t, c][0], part.imag)):
                if fast_first:
                    acc.copy_(new)
                else:
                    acc.add_(new)
            if want_power or want_vlbi:
                p, v = _beam_products_shard(cfg, pk[t][c], g[t][c],
                                            want_power, want_vlbi)
                if want_power:
                    power[t][c] = p
                if want_vlbi:
                    vlbi[t][c] = v
    dense = subsel = None
    if fast_last:
        dense, subsel = _dump(
            cfg, mesh, [[fr[t, c][0] for c in range(mesh.n_chan)]
                        for t in range(mesh.n_time)],
            [[fi[t, c][0] for c in range(mesh.n_chan)]
             for t in range(mesh.n_time)], prs, want_subsel)
        for c in range(mesh.n_chan):
            with mesh.on(0, c):
                for acc, new in ((sr[0, c], dense[c].real),
                                 (si[0, c], dense[c].imag)):
                    if slow_first:
                        acc.copy_(new)
                    else:
                        acc.add_(new)
    # VLBI beam-0 voltages need every channel: gather the small
    # [t_local, c_local, 2, 2] slabs over 'chan'
    vlbi_rows = all_gather(mesh, vlbi, axis=1) if want_vlbi else None
    return _pack_outputs(mesh, dense, subsel, power, vlbi_rows)


def xengine_sharded_state_fn(cfg: XEngineConfig, mesh: Mesh,
                             fast_first: bool, fast_last: bool,
                             slow_first: bool, want_power: bool = True,
                             want_vlbi: bool = True,
                             want_subsel: bool = True):
    """Stateful sharded fused step: the mesh analog of
    ``models.xengine.xengine_step``.

    Accumulator state lives on the mesh and never moves
    (:func:`zero_sharded_state`); it is updated in place and returned.
    Mid-window gulps are collective-free for the visibilities; the
    'time'-axis ``psum`` fires once per fast window at the dump call.
    Boundary flags select the variant, as the driver selects the
    unsharded step's flags.

    ``fn(state, packed, gains, pairs) -> (state, FxOutputs, vlbi)``:
    packed [ntime, nchan, ninput] ([time, chan]-sharded); gains
    chan-sharded; vis and subsel present only on dump variants.
    """
    _check_chan_shards(cfg, mesh)

    def fn(state, packed, gains: bf.BeamGains, pairs):
        pk = shard(mesh, packed, ("time", "chan", None))
        g = _shard_gains(mesh, gains)
        prs = _replicate(mesh, pairs)
        mesh.fork()
        out, vlbi = _state_xb_tail(cfg, mesh, state, pk.shards, g, prs,
                                   fast_first, fast_last, slow_first,
                                   want_power, want_vlbi, want_subsel)
        mesh.join()
        return state, out, vlbi

    return fn


def _channelize_turn(cfg, mesh, adc_sh, first, window, quant_scale):
    """Per shard: halo over 'time', channelize + 4-bit requant of the
    shard's inputs (all channels), then the F->X corner-turn of the
    packed bytes over 'chan'.  Quantizing BEFORE the corner-turn moves
    packed 4+4-bit bytes, 8x less than f32 planes, and is elementwise per
    (chan, input), so shard order does not change the values.  Returns
    packed [t_local, nchan_local, ninput] per shard."""
    halo_n = (cfg.pfb_ntap - 1) * 2 * cfg.nchan
    ext = _grid(mesh)
    if halo_n:
        tails = _grid(mesh)
        for t, c in mesh.coords():
            with mesh.on(t, c):
                tails[t][c] = adc_sh[t][c][-halo_n:]
        halo = ppermute_halo(mesh, tails, first)
    win = _replicate(mesh, window)
    scale = (_replicate(mesh, quant_scale)
             if isinstance(quant_scale, torch.Tensor) else None)
    pk = _grid(mesh)
    for t, c in mesh.coords():
        with mesh.on(t, c):
            ext[t][c] = (torch.cat([halo[t][c], adc_sh[t][c]])
                         if halo_n else adc_sh[t][c])
            pk[t][c] = pfb_ops.channelize_pack_imajor(
                ext[t][c], win[t][c], cfg,
                quant_scale if scale is None else scale[t][c])
    # input-major [nin_local, t_local, nchan]: split the chan axis, gather
    # inputs on axis 0; the result is laid out [t, c, input] in memory
    pk = all_to_all(mesh, pk, split_axis=2, concat_axis=0,
                    memory_order=(1, 2, 0))
    for t, c in mesh.coords():
        with mesh.on(t, c):
            pk[t][c] = pk[t][c].permute(1, 2, 0).contiguous()
    return pk


def _check_adc(cfg, mesh, adc) -> None:
    L = 2 * cfg.nchan
    if adc.shape[0] % (mesh.n_time * L):
        raise ValueError(f"{adc.shape[0]} ADC samples do not split into "
                         f"whole spectra over {mesh.n_time} time shards")


def fx_sharded_fn(cfg: XEngineConfig, mesh: Mesh):
    """Build the sharded FX+B step over ``mesh``.

    ``fn(adc, window, gains, pairs, quant_scale) -> FxOutputs`` with
      adc:    f32/int8 [ntime_total, ninput], sharded [time, chan(inputs)]
      window: f32 [ntap, 2*nchan], replicated
      gains:  BeamGains [nchan, nbeam, ninput], chan-sharded
      pairs:  int32 [nvis_out, 2], replicated.

    Per-shard flow: PFB with requant (halo via ``ppermute`` along 'time';
    time shard 0 takes zeros) -> ``all_to_all`` corner-turn of the packed
    bytes along 'chan' -> correlate (+psum over 'time') -> subsel;
    beamform + power integration stay time-sharded.
    """
    _check_chan_shards(cfg, mesh, inputs=True)
    halo_n = (cfg.pfb_ntap - 1) * 2 * cfg.nchan

    def fn(adc, window, gains: bf.BeamGains, pairs, quant_scale):
        _check_adc(cfg, mesh, adc)
        adc_sh = shard(mesh, adc, ("time", "chan"))
        g = _shard_gains(mesh, gains)
        prs = _replicate(mesh, pairs)
        mesh.fork()
        first = []
        for c in range(mesh.n_chan):
            with mesh.on(0, c):
                first.append(torch.zeros(
                    (halo_n, adc_sh[0, c].shape[1]), dtype=adc.dtype,
                    device=mesh.devices[0][c]))
        pk = _channelize_turn(cfg, mesh, adc_sh.shards, first, window,
                              quant_scale)
        pr, pi, power = _grid(mesh), _grid(mesh), _grid(mesh)
        for t, c in mesh.coords():
            with mesh.on(t, c):
                pr[t][c], pi[t][c] = _corr_gulp(cfg, pk[t][c])
                power[t][c], _ = _beam_products_shard(cfg, pk[t][c],
                                                      g[t][c])
        dense, subsel = _dump(cfg, mesh, pr, pi, prs, True)
        mesh.join()
        return _pack_outputs(mesh, dense, subsel, power, None)[0]

    return fn


def fx_packed_sharded_fn(cfg: XEngineConfig, mesh: Mesh):
    """The front half of :func:`fx_sharded_state_fn` alone: ``fn(adc,
    carry_tail, window, quant_scale)`` -> the packed bytes after the
    corner-turn, a :class:`Sharded` uint8 [nspec, nchan, ninput] split
    over (time, chan); what the sharded correlator and beamformer read."""
    _check_chan_shards(cfg, mesh, inputs=True)

    def fn(adc, carry_tail, window, quant_scale):
        _check_adc(cfg, mesh, adc)
        adc_sh = shard(mesh, adc, ("time", "chan"))
        first = shard(mesh, carry_tail, (None, "chan")).shards[0]
        mesh.fork()
        pk = _channelize_turn(cfg, mesh, adc_sh.shards, first, window,
                              quant_scale)
        mesh.join()
        return Sharded(mesh, ("time", "chan", None), pk)

    return fn


def fx_sharded_state_fn(cfg: XEngineConfig, mesh: Mesh,
                        fast_first: bool, fast_last: bool,
                        slow_first: bool, want_power: bool = True,
                        want_vlbi: bool = True,
                        want_subsel: bool = True):
    """Stateful sharded FX step: the streaming-driver analog of
    :func:`fx_sharded_fn`: PFB with on-mesh halo exchange, requant, F->X
    corner-turn, then the accumulating X/B step of
    :func:`xengine_sharded_state_fn`.

    The only host-side carry is the previous block's trailing
    ``(ntap-1)*2*nchan`` ADC samples (``carry_tail``), which time shard 0
    prepends in place of the zero halo so block boundaries are seamless,
    exactly the single-device driver's ADC tail.  Interior shard
    boundaries exchange their halo on the mesh.

    ``fn(state, adc, carry_tail, window, quant_scale, gains, pairs)
    -> (state, FxOutputs, vlbi)`` with
      adc:        f32/int8 [T, ninput], sharded [time, chan(inputs)]
      carry_tail: adc dtype [(ntap-1)*2*nchan, ninput], input-sharded
      quant_scale: scalar or per-channel [nchan], replicated.
    """
    _check_chan_shards(cfg, mesh, inputs=True)

    def fn(state, adc, carry_tail, window, quant_scale,
           gains: bf.BeamGains, pairs):
        _check_adc(cfg, mesh, adc)
        adc_sh = shard(mesh, adc, ("time", "chan"))
        first = shard(mesh, carry_tail, (None, "chan")).shards[0]
        g = _shard_gains(mesh, gains)
        prs = _replicate(mesh, pairs)
        mesh.fork()
        pk = _channelize_turn(cfg, mesh, adc_sh.shards, first, window,
                              quant_scale)
        out, vlbi = _state_xb_tail(cfg, mesh, state, pk, g, prs,
                                   fast_first, fast_last, slow_first,
                                   want_power, want_vlbi, want_subsel)
        mesh.join()
        return state, out, vlbi

    return fn


# -- the antenna-sharded correlator --------------------------------------------

class StandMesh:
    """1-D ('stand',) mesh for the antenna-sharded correlator."""

    axis_names = ("stand",)

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.shape = {"stand": len(self.devices)}


def make_stand_mesh(n_stand: int, devices=None) -> StandMesh:
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < n_stand:
        raise ValueError(f"a stand mesh of {n_stand} needs {n_stand} "
                         f"devices, {len(devices)} available")
    return StandMesh(devices[:n_stand])


def corr_stand_sharded_fn(cfg: XEngineConfig, mesh: StandMesh):
    """Antenna-sharded correlation (the tensor-parallel analog).

    Each device owns a contiguous slice of correlator inputs.  Computing
    its rows of the visibility matrix needs every column, so the packed
    voltages are all-gathered over 'stand'.  Output rows stay sharded:
    ``fn(packed) -> [Vis]``, one [nchan, ninput / n, ninput] block per
    shard; :func:`unshard_rows` concatenates them.  Plain PyTorch: the JAX
    program is an XLA dot here, not a Pallas kernel.
    """
    n = mesh.shape["stand"]
    if cfg.ninput % n:
        raise ValueError("ninput must divide the stand axis")
    w = cfg.ninput // n

    def fn(packed):
        out = []
        for k, dev in enumerate(mesh.devices):
            local = packed[:, :, k * w:(k + 1) * w].to(dev)
            # the all_gather: every shard's slice, in order, on this device
            x_all = torch.cat([packed[:, :, j * w:(j + 1) * w].to(dev)
                               for j in range(n)], dim=2)
            lr, li = (p.permute(1, 2, 0).double() for p in
                      unpack(local))           # [c, w, t]
            ar, ai = (p.permute(1, 0, 2).double() for p in
                      unpack(x_all))           # [c, t, ninput]
            vr = torch.bmm(lr, ar) + torch.bmm(li, ai)
            vi = torch.bmm(li, ar) - torch.bmm(lr, ai)
            out.append(Vis(vr.to(torch.int32), vi.to(torch.int32)))
        return out

    return fn


def unshard_rows(rows, device=None) -> Vis:
    """Row blocks of :func:`corr_stand_sharded_fn` -> [nchan, ninput,
    ninput] on ``device`` (default: the first block's)."""
    device = device or rows[0].real.device
    return Vis(torch.cat([r.real.to(device) for r in rows], dim=1),
               torch.cat([r.imag.to(device) for r in rows], dim=1))


def collective_volumes(cfg: XEngineConfig, n_time: int, n_chan: int,
                       gulp_spectra: int | None = None,
                       window_spectra: int | None = None,
                       want_vlbi: bool = True) -> dict:
    """Analytic per-collective traffic accounting for the sharded FX step
    (:func:`fx_sharded_state_fn`) at a given mesh shape, with every shard
    on a device of its own (the JAX module's dict, key for key).

    Counts bytes that cross a device boundary per *gulp* (one step call)
    and per *fast window* (``acc_len`` spectra), plus the per-device send
    rate required to run in real time (window period = ``acc_len /
    spectra_rate``).

    Formulas (D = n_time*n_chan devices, L = 2*nchan frame, h = ntap-1
    halo frames, G = gulp spectra, G_loc = G/n_time, nin_loc =
    ninput/n_chan, nchan_loc = nchan/n_chan):

    - ``ppermute`` halo ('time'): every device sends its trailing
      h*L x nin_loc ADC samples (``cfg.adc_dtype`` wide) once per gulp.
    - ``all_to_all`` corner-turn ('chan'): each device's packed slab
      [nin_loc, G_loc, nchan] moves (n_chan-1)/n_chan of itself.
    - ``psum`` visibilities ('time'): ring all-reduce of the two int32
      planes [nchan_loc, ninput, ninput] sends 2*(n_time-1)/n_time of the
      operand per device, once per FAST WINDOW, not per gulp.
    - ``all_gather`` VLBI voltages ('chan'): each device sends its
      [G_loc, nchan_loc, 2, 2] f32 shard to the other n_chan-1 ranks.
    """
    gulp = gulp_spectra or cfg.ntime_gulp
    window = window_spectra or cfg.acc_len
    D = n_time * n_chan
    L = 2 * cfg.nchan
    h = cfg.pfb_ntap - 1
    nin_loc = cfg.ninput // n_chan
    nchan_loc = cfg.nchan // n_chan
    g_loc = gulp // n_time
    gulps_per_window = window // gulp
    window_s = window / cfg.chan_bw_hz  # spectra rate = chan_bw (fs/8192)

    def entry(name, axis, active, bytes_sent_per_dev, period_gulps=1):
        per_dev = int(bytes_sent_per_dev) if active else 0
        fires_per_window = gulps_per_window // period_gulps
        return {
            "collective": name, "mesh_axis": axis,
            "per_device_bytes_per_fire": per_dev,
            "fires_per_window": fires_per_window,
            "total_bytes_per_window": per_dev * D * fires_per_window,
            "per_device_gbps_realtime":
                per_dev * fires_per_window * 8 / window_s / 1e9,
        }

    vis_plane_dev = 2 * nchan_loc * cfg.ninput * cfg.ninput * 4
    vols = [
        entry("ppermute_halo", "time", n_time > 1 and h > 0,
              h * L * nin_loc * cfg.adc_np_dtype.itemsize),
        entry("all_to_all_corner_turn", "chan", n_chan > 1,
              nin_loc * g_loc * cfg.nchan * (n_chan - 1) / n_chan),
        entry("psum_visibilities", "time", n_time > 1,
              vis_plane_dev * 2 * (n_time - 1) / n_time,
              period_gulps=gulps_per_window),
        entry("all_gather_vlbi", "chan", want_vlbi and n_chan > 1,
              g_loc * nchan_loc * 2 * 2 * 4 * (n_chan - 1)),
    ]
    total_dev_gbps = sum(v["per_device_gbps_realtime"] for v in vols)
    return {"mesh": {"time": n_time, "chan": n_chan, "devices": D},
            "gulp_spectra": gulp, "window_spectra": window,
            "window_seconds": window_s,
            "collectives": vols,
            "per_device_gbps_realtime_total": total_dev_gbps}


def fx_reference_unsharded(cfg: XEngineConfig, adc, window, gains, pairs,
                           quant_scale, n_time_shards: int = 1):
    """Single-device reference of :func:`fx_sharded_fn` on the plain
    versions, reproducing time shard 0's zero-halo start (for equality
    tests).  Returns FxOutputs of plain tensors, vis dense."""
    t_local = adc.shape[0] // n_time_shards
    halo_n = (cfg.pfb_ntap - 1) * 2 * cfg.nchan
    spectra = []
    for s in range(n_time_shards):
        lo = s * t_local
        halo = (torch.zeros((halo_n,) + adc.shape[1:], dtype=adc.dtype,
                            device=adc.device)
                if s == 0 else adc[lo - halo_n:lo])
        ext = torch.cat([halo, adc[lo:lo + t_local]])
        spectra.append(pfb_ops.pfb_quantize_packed_ref(
            ext, torch.as_tensor(window), cfg.nchan, cfg.pfb_ntap,
            quant_scale, cfg.pfb_precision == "bf16"))
    packed = torch.cat(spectra, dim=1).permute(1, 2, 0).contiguous()
    xc = corr.chan_major(packed, "tci")
    vis = corr.correlate_chan_major(xc)
    subsel = cs.corr_subsel_ref(vis, pairs.clamp(0, cfg.ninput - 1),
                                cfg.nchan_sum)
    power, _ = bf.beamform_products_ref(xc, gains, cfg.ntime_sum, True,
                                        False)
    return FxOutputs(vis, subsel, power)
