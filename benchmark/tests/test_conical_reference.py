"""The conical mode's reference (benchmark/reference/conical.py) against the
port's conical render (spacetime_tpu_torch.ops.curved) on the CPU at a
tiny size: equal stage by stage and for the whole frame, image and
counters, with one defect and with two, opaque and not, on two seeds; and
the defect matters in that scene."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import conical, retarded
from benchmark.tests.test_harness_reference import _port_scene

H = 0.005
W = HT = 48
ONE = ((0.02, 0.03), 5.0)
TWO = (ONE, ((-0.1, 0.08), 4.5))


def _bodies(seed):
    """Two small discs, one passing the defects, one crossing between them
    and the camera, their speeds drawn from the seed."""
    r = np.random.default_rng(seed)
    return [{"kind": "disc", "size": 49, "offset": [0.0, -0.08],
             "vel": [0.0, float(r.uniform(0.25, 0.4))], "rgb": [0.2, 0.9, 0.3]},
            {"kind": "disc", "size": 29, "offset": [-0.05, -0.03],
             "vel": [float(r.uniform(0.03, 0.08)), 0.0], "rgb": [0.9, 0.4, 0.2]}]


def _frame(seed, specs, **params):
    """The port's ring, particles, objects and camera, the port's render
    parameters and defects, and the reference's ring, camera, parameters,
    defects and colours, of one frame."""
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.ops import curved, raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    bodies = _bodies(seed)
    p, objects = _port_scene(bodies)
    buf = wl.prefill_inertial(wl.create(128, p.capacity, device="cpu"), p.pos, p.vel, p.active,
                              127 * H, H)
    cam = Camera.create(pos=(-0.08, 0.0), zoom=0.25, device="cpu")
    rp = raytrace.RenderParams(**dict(dict(dt=H, num_rays=512, cell_px=8, bin_capacity=128,
                                           ray_chunk=1024), **params))
    ds = tuple(curved.ConicalDefect.create(c, d, device="cpu") for c, d in specs)
    port = dict(buf=buf, p=p, objects=objects, cam=cam, params=rp, defects=ds)
    ref = dict(ring=retarded.Ring(*(getattr(buf, f) for f in check.RING_FIELDS)),
               cam=retarded.Camera(cam.pos, cam.zoom, cam.vel),
               params=retarded.RenderParams.from_fields(dataclasses.asdict(rp)),
               defects=conical.defects([[list(c), d] for c, d in specs], "cpu"),
               colors=torch.tensor([b["rgb"] for b in bodies], dtype=torch.float32))
    return port, ref


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, torch.as_tensor(b)), (a, b)
    else:
        assert a == b


CASES = [(seed, specs, params) for seed in (11, 12) for specs in ((ONE,), TWO)
         for params in ({"opaque": True, "pair_budget": 1024, "segments": 3},
                        {"opaque": False, "band": 5})]


@pytest.mark.parametrize("seed,specs,params", CASES)
def test_the_conical_reference_agrees_with_the_port_stage_by_stage(seed, specs, params):
    from spacetime_tpu_torch.ops import curved, raytrace
    from spacetime_tpu_torch.ops.worldline import newest_time

    port, ref = _frame(seed, specs, **params)
    buf, p, cam, rp = port["buf"], port["p"], port["cam"], port["params"]
    rcam, rparams = ref["cam"], ref["params"]
    t_now = newest_time(buf)
    assert torch.equal(t_now, retarded.newest_time(ref["ring"]))
    # 1. one band sweep per route
    mine, theirs = [], []
    for d, rd in [(None, None)] + list(zip(port["defects"], ref["defects"])):
        fn = None if d is None else (
            lambda qx, qy, d=d: curved.geodesic_lengths_xy(qx, qy, cam.pos[0], cam.pos[1], d)[1])
        rfn = None if rd is None else (
            lambda qx, qy, rd=rd: conical.geodesic_lengths_xy(qx, qy, rcam.pos[0], rcam.pos[1],
                                                              rd)[1])
        theirs.append(curved._band_pairs(buf, p.object_index, port["objects"], cam, t_now, W, HT,
                                         rp, cull_hull=False, route_lengths=fn))
        mine.append(retarded._band_pairs(ref["ring"], p.object_index, ref["colors"], rcam, t_now,
                                         W, HT, rparams, cull_hull=False, route_lengths=rfn))
        _equal(tuple(theirs[-1]), tuple(mine[-1]))
    assert int(mine[1][0].n_pairs) > 0  # the back route crosses matter
    # 2. the shared pair budget
    cat = lambda ps, cls: cls(pdata=torch.cat([x[0].pdata for x in ps]),
                              pair_valid=torch.cat([x[0].pair_valid for x in ps]),
                              n_pairs=sum(x[0].n_pairs for x in ps))
    pairs = raytrace._compact_pairs_to_budget(cat(theirs, raytrace.PairData), rp.pair_budget)
    rpairs = retarded._compact_pairs_to_budget(cat(mine, retarded.PairData), rparams.pair_budget)
    _equal(tuple(pairs), tuple(rpairs))
    # 3. the view tables
    tables, *rest = raytrace._build_view_tables(pairs, cam, W, HT, rp)
    rtables, *rrest = conical._build_view_tables(rpairs, rcam, W, HT, rparams)
    _equal(tuple(tables), tuple(rtables))
    _equal(tuple(rest), tuple(rrest))
    # 4. a retina per route, route 2's over the rotated images
    retinas = rretinas = None
    if rp.opaque:
        retinas = [raytrace._retina(pairs, cam, t_now, rp)]
        rretinas = [retarded._retina(rpairs, rcam, t_now, rparams)]
        for d, rd in zip(port["defects"], ref["defects"]):
            images = curved._route2_image_pairs(pairs, cam, d)
            rimages = conical._route2_image_pairs(rpairs, rcam, rd)
            _equal(tuple(images), tuple(rimages))
            retinas.append(raytrace._retina(images, cam, t_now, rp))
            rretinas.append(retarded._retina(rimages, rcam, t_now, rparams))
        _equal(tuple(retinas), tuple(rretinas))
    # 5. the route pass, block by block
    pxs, pys = raytrace._cell_pixel_coords(W, HT, cam, rp)
    _equal((pxs, pys), conical._cell_pixel_coords(W, HT, rcam, rparams))
    blocks = raytrace._cell_blocks(tables.n_img_cells, rp)
    assert blocks == conical._cell_blocks(rtables.n_img_cells, rparams)
    for b in blocks:
        _equal(curved._route_pass_block(tables.vdat[b], tables.vok[b], pxs[b], pys[b], t_now, cam,
                                        port["defects"], retinas, rp),
               conical._route_pass_block(rtables.vdat[b], rtables.vok[b], pxs[b], pys[b], t_now,
                                         rcam, ref["defects"], rretinas, rparams))
    # 6. the whole frame: image and counters
    img, diag = curved.render_retarded_conical_with_diag(buf, p.object_index, port["objects"],
                                                         cam, port["defects"], W, HT, rp,
                                                         planar=True)
    rimg, rdiag = conical.render(ref["ring"], p.object_index, ref["colors"], rcam,
                                 ref["defects"], W, HT, rparams)
    assert torch.equal(img, rimg) and (img != 1.0).any()
    assert diag._fields == rdiag._fields
    _equal(tuple(diag), tuple(rdiag))


@pytest.mark.parametrize("specs", [(ONE,), TWO])
def test_the_defect_matters_in_that_scene(specs):
    port, ref = _frame(11, specs)

    def render(defs):
        return conical.render(ref["ring"], port["p"].object_index, ref["colors"], ref["cam"],
                              defs, W, HT, ref["params"])[0]

    flat = tuple(conical.Defect(d.center, torch.zeros_like(d.deficit)) for d in ref["defects"])
    differs = ((render(ref["defects"]) - render(flat)).abs() > check.PIXEL_TOL).any(dim=0)
    assert float(differs.double().mean()) > 0.01


def test_a_configuration_names_one_defect_or_several():
    one = conical.defects([[0.5, 0.55], 1.2], "cpu")
    assert len(one) == 1 and one[0].center.tolist() == [0.5, 0.550000011920929]
    assert one[0].deficit.dtype == torch.float32 and float(one[0].deficit) == np.float32(1.2)
    two = conical.defects([[[0.5, 0.55], 1.2], [[0.2, 0.3], 0.4]], "cpu")
    assert [float(d.deficit) for d in two] == [np.float32(1.2), np.float32(0.4)]
