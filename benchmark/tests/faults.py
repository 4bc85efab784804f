"""Faults planted underneath the timed path, each a module-level function
``fault(set)`` (``set(obj, name, value)`` patches and is undone after the
run), so a rank started by ``spawn`` can plant it too."""


def frame_unchanged(set_):
    """Every launch of the device pass returns, its carry left as it was."""
    from ptx_torch.integrator import graphs

    set_(graphs.DevicePass, "accumulate", lambda self, fs, s, count: None)


def frame_half_pixels(set_):
    """Each launch folds only its first half of pixels (a frame of one
    launch has no second launch to leave out)."""
    from ptx_torch.integrator import graphs

    fold = graphs.fold_mean

    def half(carry, colors, alphas, f):
        n = colors.shape[1] // 2
        fold(tuple(c[:n] for c in carry), colors[:, :n], alphas[:, :n], f)

    set_(graphs, "fold_mean", half)


def frame_altered(set_):
    """Every sample's radiance altered by a thousandth where it is folded."""
    from ptx_torch.integrator import graphs

    fold = graphs.fold_mean
    set_(graphs, "fold_mean",
         lambda carry, colors, alphas, f: fold(carry, colors * 1.001, alphas, f))


def exchange_left_out(set_):
    """A tp rank's closest and any hits without the exchange: each rank
    sees its own shard only."""
    from ptx_torch.parallel import dist

    set_(dist, "sharded_closest", lambda base, mesh: base)
    set_(dist, "sharded_any_hit", lambda base, mesh: base)


def inverse_unchanged(set_):
    """The value and gradient returns zero gradients: Adam leaves every
    parameter where it was."""
    from ptx_torch.diff import inverse

    make = inverse.make_batch_value_and_grad_fn

    def zero(*a, **k):
        vg = make(*a, **k)

        def f(params, fs):
            v, g = vg(params, fs)
            return v, {n: x * 0.0 for n, x in g.items()}

        return f

    set_(inverse, "make_batch_value_and_grad_fn", zero)


def inverse_half_batch(set_):
    """The loss and gradient over the first half of the pixels, scaled as
    their mean."""
    from ptx_torch.diff import inverse

    slice_ = inverse.slice_value_and_grad_fn

    def half(integrator, cfg, target, n_samples, first, count, *a, **k):
        vg = slice_(integrator, cfg, target, n_samples, first, count // 2,
                    *a, **k)

        def f(params, fs):
            v, g = vg(params, fs)
            return v * 2.0, {n: x * 2.0 for n, x in g.items()}

        return f

    set_(inverse, "slice_value_and_grad_fn", half)


def inverse_altered(set_):
    """The loss altered by a thousandth where the value is produced."""
    from ptx_torch.diff import inverse

    make = inverse.make_batch_value_and_grad_fn

    def altered(*a, **k):
        vg = make(*a, **k)

        def f(params, fs):
            v, g = vg(params, fs)
            return v * 1.001, g

        return f

    set_(inverse, "make_batch_value_and_grad_fn", altered)


def jax_held_by_rank_1(set_):
    """Rank 1's process holds a module named ``jax`` once its loop has
    ended (its window closed, its check done)."""
    import sys
    import types

    from benchmark import common

    load = common.load_module

    def loaded(kind, name):
        module = load(kind, name)
        if kind != "kinds":
            return module
        loop = module.run

        def run(ctx):
            out = loop(ctx)
            if ctx.rank == 1:
                sys.modules["jax"] = types.ModuleType("jax")
            return out

        module.run = run
        return module

    set_(common, "load_module", loaded)
