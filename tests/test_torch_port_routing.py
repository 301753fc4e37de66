"""The Clos-routed mix backward of the port (spectre_tpu_torch/ops/routing.py,
ops/kernels/routed_gather.py, ops/fused_mix.py's routes, the trainer's
``mix_routed``) against the JAX package on the CPU: the route tables bit for
bit, kernel B9's plain version against the Pallas kernel in interpret mode
bit for bit in f32 and bf16, the "takes" and "mxu" routes, and the routed
folded mix's gradients. Inputs come from numpy seeds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spectre_tpu.models.layers import MHPermutMix as JaxMHPermutMix
from spectre_tpu.ops import routing as jax_routing
from spectre_tpu.ops.fused_mix import clear_mix_routes as jax_clear_mix_routes
from spectre_tpu.ops.fused_mix import register_mix_routes as jax_register_mix_routes
from spectre_tpu.ops.pallas.routed_gather import routed_gather_sum_pallas
from spectre_tpu_torch.configs import CONFIG_DIR
from spectre_tpu_torch.models import MHPermutMix, load_flax_variables
from spectre_tpu_torch.ops import (
    ROUTE_IMPLS,
    clear_mix_routes,
    derive_mix_route,
    register_mix_routes,
    routing,
)
from spectre_tpu_torch.ops.kernels import (
    inverse_gather_sum_plain,
    launch_counts,
    routed_gather_sum,
    routed_gather_sum_plain,
)
from spectre_tpu_torch.ops.kernels import routed_gather as routed_gather_module
from spectre_tpu_torch.repl import train as train_cli


@pytest.fixture(autouse=True)
def _route_cache(tmp_path, monkeypatch):
    """Every route table this file builds is cached under tmp_path."""
    monkeypatch.setattr(routing, "ROUTE_CACHE_DIR", str(tmp_path / "routes"))


def _inverse(h, d, seed):
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(d) for _ in range(h)]).astype(np.int32)
    return perms, np.argsort(perms, axis=1).astype(np.int32)


def _tables(rt):
    return [torch.from_numpy(t) for t in (rt.a_idx, rt.b_idx, rt.c_idx)]


# ---- the tables -------------------------------------------------------------------------


@pytest.mark.parametrize("h,d,c", [(4, 256, 128), (3, 544, 32), (1, 33_280, 128)])
def test_route_tables_are_jax_bit_for_bit(h, d, c):
    """d = 256 (c = 128), d = 544 (c = 32) and one head at the flagship's
    d = 33,280 (c = 128, r = 260)."""
    _, inv = _inverse(h, d, seed=d)
    got, want = routing.build_route_tables(inv), jax_routing.build_route_tables(inv)
    assert (got.r, got.c) == (want.r, want.c) == (d // c, c)
    for name in ("a_idx", "b_idx", "c_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32 and a.shape == (h, d // c, c)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_edge_color_is_proper_and_pick_factor_agrees_with_jax():
    """Each (vertex, colour) pair occurs exactly once on both sides."""
    rng = np.random.default_rng(7)
    r, c = 13, 8
    d = r * c
    for _ in range(3):
        sig = rng.permutation(d)
        src, dst = sig // c, np.arange(d) // c
        col = routing.edge_color(src, dst, c)
        np.testing.assert_array_equal(col, jax_routing.edge_color(src, dst, c))
        left, right = np.zeros((r, c), np.int32), np.zeros((r, c), np.int32)
        np.add.at(left, (src, col), 1)
        np.add.at(right, (dst, col), 1)
        assert (left == 1).all() and (right == 1).all()
    with pytest.raises(ValueError, match="power-of-two"):
        routing.edge_color(src, dst, 6)
    for d in range(1, 4200):
        assert routing.pick_factor(d) == jax_routing.pick_factor(d), d
    assert routing.pick_factor(33_280) == 128 and routing.pick_factor(49_920) == 128
    assert routing.pick_factor(800) == 32 and routing.pick_factor(33) == 0


def test_unfactorable_width_raises():
    _, inv = _inverse(1, 33, seed=0)
    with pytest.raises(ValueError, match="no usable power-of-two factor"):
        routing.build_route_tables(inv)
    with pytest.raises(ValueError, match="no usable power-of-two factor"):
        routing.build_route_tables(_inverse(1, 64, seed=0)[1], c=48)


def test_route_cache_round_trips_under_its_directory(tmp_path, monkeypatch):
    _, inv = _inverse(3, 544, seed=1)
    cache = tmp_path / "cache"
    first = routing.build_route_tables_cached(inv, cache_dir=str(cache))
    files = os.listdir(cache)
    assert len(files) == 1 and files[0].endswith(".npz")  # no temporary file is left

    def no_build(*args, **kw):
        raise AssertionError("the cached tables were built again")

    monkeypatch.setattr(routing, "build_route_tables", no_build)
    again = routing.build_route_tables_cached(inv, cache_dir=str(cache))
    assert (again.r, again.c) == (first.r, first.c) == (17, 32)
    for name in ("a_idx", "b_idx", "c_idx"):
        np.testing.assert_array_equal(getattr(again, name), getattr(first, name))
    with pytest.raises(AssertionError, match="built again"):  # another c, another file
        routing.build_route_tables_cached(inv, c=16, cache_dir=str(cache))


# ---- kernel B9's plain version and the two jnp routes ------------------------------------


@pytest.mark.parametrize("b", [16, 13])
def test_routed_gather_plain_is_the_pallas_kernel_bit_for_bit(b):
    """JAX's own test shape (h=4, d=256) at b=16 and at a b that is no
    multiple of 8; f32 and bf16 (the bf16 head chain, rounded after every
    head). In f32 it is also kernel 4's float32 sum."""
    h, d = 4, 256
    _, inv = _inverse(h, d, seed=b)
    rt = jax_routing.build_route_tables(inv)
    g = np.random.default_rng(b).standard_normal((h * d, b)).astype(np.float32)
    tables = _tables(routing.build_route_tables(inv))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        gj = jnp.asarray(g, jdt)
        want = np.asarray(routed_gather_sum_pallas(gj, rt, interpret=True).astype(jnp.float32))
        gt = torch.tensor(np.asarray(gj.astype(jnp.float32))).to(tdt)
        got = routed_gather_sum_plain(gt, *tables)
        assert got.dtype == tdt and got.shape == (d, b)
        np.testing.assert_array_equal(got.float().numpy(), want)
        assert torch.equal(routed_gather_sum(gt, *tables), got)  # the CPU path is plain
        if tdt == torch.float32:
            assert torch.equal(got, inverse_gather_sum_plain(gt, torch.from_numpy(inv)))


def test_takes_and_mxu_routes_match_jax_in_f32():
    """The "takes" route and the one-hot operators are JAX's bit for bit. The
    "mxu" route is bit for bit the float32 head sum in head order (JAX's
    "takes" result): torch's product adds the one nonzero term of each head
    in head order. JAX's own "mxu" route contracts head and colour in one
    XLA product whose order of addition is its own; it is held to that
    within JAX's own test tolerance for it (tests/test_routing.py)."""
    for h, d, b in ((4, 64, 16), (3, 256, 8), (2, 520, 5)):
        _, inv = _inverse(h, d, seed=d)
        rt = jax_routing.build_route_tables(inv)
        g = np.random.default_rng(d).standard_normal((h * d, b)).astype(np.float32)
        a, bb, c = _tables(routing.build_route_tables(inv))
        gt = torch.from_numpy(g)
        takes = np.asarray(jax_routing.route_gather_sum(g, rt))
        np.testing.assert_array_equal(routing.route_gather_sum(gt, a, bb, c).numpy(), takes)
        ohs = routing.route_onehots(a, bb, c, torch.float32)
        johs = jax_routing.route_onehots(rt, jnp.float32)
        for got, want in zip(ohs, johs):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        mxu = routing.route_gather_sum_mxu(gt, *ohs).numpy()
        np.testing.assert_array_equal(mxu, takes)
        np.testing.assert_allclose(mxu, np.asarray(jax_routing.route_gather_sum_mxu(g, *johs)),
                                   rtol=1e-6, atol=1e-5)


def test_routed_gather_wrapper_checks_before_it_launches():
    _, inv = _inverse(2, 64, seed=0)
    tables = _tables(routing.build_route_tables(inv, c=8))
    g = torch.zeros(2 * 64, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        routed_gather_sum(g.to("meta"), *(t.to("meta") for t in tables))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        routed_gather_sum(g.half(), *tables)
    with pytest.raises(TypeError, match="int32"):
        routed_gather_sum(g, tables[0], tables[1].long(), tables[2])
    with pytest.raises(ValueError, match="rows"):
        routed_gather_sum(g[:-1], *tables)
    with pytest.raises(ValueError, match="contiguous"):
        routed_gather_sum(torch.zeros(4, 2 * 64).t(), *tables)
    with pytest.raises(ValueError):
        routed_gather_sum(g, tables[0], tables[1][:, :4], tables[2])


# ---- the routed folded mix ----------------------------------------------------------------


def _jax_mix_and_port(e=32, n=17, h=3, b=8):
    """JAX's own test case (d = 544 = 17 x 32): a folded MHPermutMix with its
    variables, a port module carrying them, and a numpy batch."""
    x = np.random.default_rng(3).standard_normal((b, n, e)).astype(np.float32)
    jm = JaxMHPermutMix(embed_dim=e, token_dim=n, num_heads=h, out_channels=e, impl="folded")
    v = jax.tree.map(np.array, jm.init(jax.random.key(0), jnp.asarray(x)))
    port = load_flax_variables(MHPermutMix(e, n, h, e, impl="folded"), v)
    return jm, v, port, x


def _port_grads(port, x):
    port.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) ** 2).sum().backward()
    return [xt.grad] + [p.grad for _, p in port.named_parameters()]


def test_routed_mix_backward_is_jax_bit_for_bit_and_every_gradient_matches(monkeypatch):
    """JAX's own case (e=32, n=17, h=3, b=8; d = 544 = 17 x 32). The mix's
    backward through the route (impl "pallas": kernel B9's plain version on
    the CPU) equals JAX's ``perm_rows_t_keyed`` backward under
    ``register_mix_routes(impl="pallas")`` (its Pallas kernel in interpret
    mode) bit for bit, in f32 and bf16. Every gradient of the routed folded
    mix equals the unrouted port's bit for bit (in f32 the routed head chain
    is kernel 4's float32 sum), and JAX's within 1e-4 of each gradient's
    largest entry, the tolerance of the port's gradient tests: the products
    around the mix add in another order in torch than in XLA. A call counter
    on the plain version shows the routed path was taken."""
    from spectre_tpu.ops.fused_mix import perm_rows_t_keyed
    from spectre_tpu_torch.ops import perm_rows_t

    jm, v, port, x = _jax_mix_and_port()
    calls = []
    plain = routed_gather_module.routed_gather_sum_plain
    monkeypatch.setattr(routed_gather_module, "routed_gather_sum_plain",
                        lambda *a: calls.append(1) or plain(*a))
    perms = v["buffers"]["mix_tables"][0]
    d = perms.shape[1]
    rng = np.random.default_rng(5)
    xt, g = rng.standard_normal((d, 8)), rng.standard_normal((3 * d, 8))

    def loss(params, xx):
        return (jm.apply({"params": params, "buffers": v["buffers"]}, xx) ** 2).sum()

    want_plain = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    jax_register_mix_routes({"buffers": {"mix": v["buffers"]}}, impl="pallas")
    try:
        mix_bwd = {}
        for jdt in (jnp.float32, jnp.bfloat16):
            _, vjp = jax.vjp(lambda a: perm_rows_t_keyed(a, jnp.asarray(perms), "mix"),
                             jnp.asarray(xt, jdt))
            mix_bwd[jdt] = np.asarray(vjp(jnp.asarray(g, jdt))[0].astype(jnp.float32))
    finally:
        jax_clear_mix_routes()
    jax_register_mix_routes(v, impl="pallas")
    try:
        want_p, want_x = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    finally:
        jax_clear_mix_routes()
    for a, b in zip(jax.tree.leaves(want_plain), jax.tree.leaves((want_p, want_x))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    unrouted = _port_grads(port, x)
    assert register_mix_routes(port, "pallas") == 1 and not calls
    mix = port.refresh()
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        a = torch.tensor(np.asarray(jnp.asarray(xt, jdt).astype(jnp.float32))).to(tdt)
        ct = torch.tensor(np.asarray(jnp.asarray(g, jdt).astype(jnp.float32))).to(tdt)
        a.requires_grad_()
        perm_rows_t(a, mix.tables, mix.route).backward(ct)
        np.testing.assert_array_equal(a.grad.float().numpy(), mix_bwd[jdt])
    assert len(calls) == 2
    routed = _port_grads(port, x)
    assert len(calls) == 3, "the routed backward was not taken"
    names = [name for name, _ in port.named_parameters()]
    want = [np.asarray(want_x)] + [np.asarray(want_p["linear"][n.split(".")[1]]) for n in names]
    for name, got, base, ref in zip(["x"] + names, routed, unrouted, want):
        assert torch.equal(got, base), name
        scale = float(np.abs(ref).max())
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("impl", ROUTE_IMPLS)
def test_every_route_impl_gives_the_unrouted_gradients(impl):
    """In f32 each route impl passes every value through exactly and sums the
    heads in head order from zero, so the gradients equal the block/row
    backward's bit for bit; the route is derived once, with the tables."""
    _, _, port, x = _jax_mix_and_port(e=16, n=5, h=4, b=3)  # d = 80: c = 16
    base = _port_grads(port, x)
    derived = port.table_derivations
    assert register_mix_routes(port, impl) == 1 and port.route_impl == impl
    assert port.table_derivations == derived + 1
    route = port.refresh().route
    assert route.impl == impl and route.a_idx.shape == (4, 5, 16)
    assert (route.onehots is not None) == (impl == "mxu")
    for got, want in zip(_port_grads(port, x), base):
        assert torch.equal(got, want)
    assert port.table_derivations == derived + 1  # the steps derived nothing
    clear_mix_routes(port)
    assert port.route_impl is None and port.refresh().route is None


def test_a_buffer_change_derives_the_route_again_and_unroutable_mixes_stay_unrouted():
    """A routed mix that is given other tables (load_state_dict, as a restore
    does) routes by the new ones; a mix whose d has no power-of-two factor
    >= 8, or that is not folded, takes no route, as in JAX."""
    _, _, port, x = _jax_mix_and_port(e=16, n=5, h=2, b=4)
    other = MHPermutMix(16, 5, 2, 16, impl="folded")
    from spectre_tpu_torch.models.init import init_weights
    init_weights(other, torch.Generator().manual_seed(9))
    assert not torch.equal(other.perms, port.perms)
    want = _port_grads(other, x)
    register_mix_routes(port, "pallas")
    port.load_state_dict(other.state_dict())
    route = port.refresh().route
    fresh = derive_mix_route(other.perms, "pallas", torch.float32)
    for a, b in zip(route[1:4], fresh[1:4]):
        assert torch.equal(a, b)
    for got, ref in zip(_port_grads(port, x), want):
        assert torch.equal(got, ref)
    odd = MHPermutMix(3, 11, 2, 3, impl="folded")  # d = 33
    gather = MHPermutMix(16, 5, 2, 16, impl="gather")
    model = torch.nn.Sequential(odd, gather)
    init_weights(model, torch.Generator().manual_seed(1))
    assert register_mix_routes(model, "takes") == 0
    assert odd.route_impl is None and gather.route_impl is None
    with pytest.raises(ValueError, match="unknown mix route impl"):
        register_mix_routes(model, "einsum")


def test_train_cli_with_mix_routed_registers_routes_and_derives_them_after_a_restore(
        tmp_path, capsys, monkeypatch):
    """``repl/train.py``'s ``main`` with ``--set mix_routed=True
    mix_routed_impl=pallas`` at spectre_vit_mnist's widths with one layer
    (d = 800: c = 32): the route is registered, every backward goes through
    kernel B9 (its plain version here), and a resumed run registers it again
    from the restored buffers. With the knob off nothing is routed."""
    calls = []
    plain = routed_gather_module.routed_gather_sum_plain
    monkeypatch.setattr(routed_gather_module, "routed_gather_sum_plain",
                        lambda *a: calls.append(1) or plain(*a))
    config = os.path.join(CONFIG_DIR, "spectre_vit_mnist.py")
    args = ["--device", "cpu", "--config", config, "--synthetic", "--set", "num_encoders=1",
            "batch_size=16", "val_batch_size=512", f"checkpoint_dir={tmp_path}",
            "mix_routed=True", "mix_routed_impl=pallas"]
    before = launch_counts()
    first = train_cli.main(args[:4] + ["--steps", "2"] + args[4:])
    out = capsys.readouterr().out
    assert "mix routes registered: 1" in out and first.state.step == 2
    assert len(calls) == 2
    mix = first.state.model.encoder_blocks.layer_0.mix_layer
    assert mix.route_impl == "pallas"
    resumed = train_cli.main(args[:4] + ["--steps", "3", "--resume"] + args[4:])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "mix routes registered: 1" in out
    assert resumed.state.step == 3 and len(calls) == 3
    mix = resumed.state.model.encoder_blocks.layer_0.mix_layer
    want = derive_mix_route(mix.perms, "pallas", torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(mix.refresh().route[1:4], want[1:4]))
    assert torch.equal(mix.perms, first.state.model.encoder_blocks.layer_0.mix_layer.perms)
    assert launch_counts() == before
    off = train_cli.main(args[:4] + ["--steps", "1", "--no-checkpoint"] + args[4:-2])
    assert "mix routes registered" not in capsys.readouterr().out and len(calls) == 3
    assert off.state.model.encoder_blocks.layer_0.mix_layer.route_impl is None
