"""Optimization methods (port of ``bigdl_tpu/optim/optim_method.py``:
``OptimMethod``, ``SGD`` (with its bf16 ``state_dtype``), ``Adam``,
``ParallelAdam``, ``Adagrad``, ``Adadelta``, ``Adamax``, ``RMSprop``,
``Ftrl`` and ``LBFGS``).

Parameters, gradients and state are dicts of tensors keyed by parameter
name, or lists of tensors: ``DistriOptimizer``'s flat f32 master buckets
(``parallel/grad_sync.py``), whose state is then the reference's layout
over them, e.g. ``{"velocity": [bucket, ...]}``.  Every method but LBFGS
is elementwise, so a bucket's update is the update of the parameters in
it, bit for bit.  Where the reference's ``update`` is pure and returns new
trees, here it updates the parameters and the state IN PLACE under
``torch.no_grad()``: the training loop owns both, and in-place updates
keep one copy of each on the card.  The arithmetic follows the reference
step for step, with its state key names.  No update reads a value back
to the host: LBFGS's branches are ``torch.where`` selects over device
scalars, so a K-step block stays free of syncs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule
from bigdl_tpu_torch.utils.precision import stochastic_round_bits

Tensors = Union[Dict[str, torch.Tensor], List[torch.Tensor]]


def _keys(tree: Tensors):
    return tree.keys() if isinstance(tree, dict) else range(len(tree))


def _like(tree: Tensors, make) -> Tensors:
    if isinstance(tree, dict):
        return {k: make(p) for k, p in tree.items()}
    return [make(p) for p in tree]


def _zeros_like(tree: Tensors) -> Tensors:
    return _like(tree, torch.zeros_like)


class OptimMethod:
    """Base optimizer: ``init_state(params)`` and ``update(grads, params,
    state, lr, step)``; ``current_lr`` runs on the host."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.learning_rate_schedule = learning_rate_schedule
        self.weight_decay = weight_decay

    def current_lr(self, iteration: int, epoch: int,
                   metric: Optional[float] = None) -> float:
        if self.learning_rate_schedule is None:
            return self.learning_rate
        return self.learning_rate_schedule(self.learning_rate, iteration,
                                           epoch, metric)

    def init_state(self, params: Tensors) -> dict:
        return {}

    def update(self, grads: Tensors, params: Tensors, state: dict,
               lr: float, step: int) -> None:
        raise NotImplementedError

    def _decayed(self, grads: Tensors, params: Tensors) -> Tensors:
        """L2 weight decay folded into the gradient."""
        if self.weight_decay == 0.0:
            return grads
        wd = self.weight_decay
        if isinstance(grads, dict):
            return {k: g + wd * params[k] for k, g in grads.items()}
        return [g + wd * p for g, p in zip(grads, params)]


# the stochastic rounding of SGD's bf16 velocity draws its 16 noise bits
# from a counter-based hash of (the f32 value's bits, the step): a pure
# function of each element, so a parameter's velocity rounds the same way
# whether it sits in a dict or in a flat grad_sync bucket, on the CPU or on
# the card (the reference folds the step into a threefry key instead, a
# stream no torch generator reproduces)
_STATE_SEED = 0x5BD1
_HASH_MULS = (0x7FEB352D, 0x5BD1E995)  # odd, < 2**31: int64 products fit


def state_noise(x: torch.Tensor, step: int) -> torch.Tensor:
    """Uniform 16-bit words (int32) for :func:`stochastic_round_bits` of the
    f32 tensor ``x`` at optimizer step ``step``."""
    salt = ((_STATE_SEED << 20) ^ (int(step) * 0x9E3779B1)) & 0xFFFFFFFF
    h = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) ^ salt
    for mul in _HASH_MULS:
        h = h ^ (h >> 16)
        h = (h * mul) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    return (h & 0xFFFF).to(torch.int32)


class SGD(OptimMethod):
    """SGD with momentum, dampening and nesterov (Torch semantics:
    ``v = mu*v + (1-dampening)*g``; nesterov steps along ``g + mu*v``).

    ``state_dtype=torch.bfloat16`` stores the velocity in bf16: each step
    accumulates it in f32, steps with the f32 value, and stores it
    stochastically rounded (:func:`state_noise`), so updates under half a
    bf16 ulp survive on average instead of being dropped."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None,
                 state_dtype: Optional[torch.dtype] = None):
        if learning_rate_schedule is None and learning_rate_decay != 0.0:
            learning_rate_schedule = Default(learning_rate_decay)
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.state_dtype = state_dtype
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        if self.momentum == 0.0:
            return {}
        dt = self.state_dtype
        return {"velocity": _like(params, lambda p: torch.zeros_like(
            p, dtype=dt if dt is not None else p.dtype))}

    def _round(self, v32: torch.Tensor, step: int) -> torch.Tensor:
        return stochastic_round_bits(v32, self.state_dtype,
                                     state_noise(v32, step))

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        if self.momentum == 0.0:
            for k in _keys(params):
                params[k].sub_(lr * grads[k])
            return
        mu, damp = self.momentum, self.dampening
        for k in _keys(params):
            p, v = params[k], state["velocity"][k]
            g = grads[k]
            if self.state_dtype is None:
                v.copy_(mu * v + (1 - damp) * g)
                p.sub_(lr * (g + mu * v if self.nesterov else v))
                continue
            v32 = mu * v.float() + (1 - damp) * g.float()
            p.sub_(lr * (g + mu * v32 if self.nesterov else v32))
            v.copy_(self._round(v32, step))


class Adam(OptimMethod):
    """Adam with bias correction."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        if learning_rate_schedule is None and learning_rate_decay != 0.0:
            learning_rate_schedule = Default(learning_rate_decay)
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = step + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for k in _keys(params):
            p, g, m, v = params[k], grads[k], state["m"][k], state["v"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


class ParallelAdam(Adam):
    """The reference's ``ParallelAdam`` multi-threads Adam over chunks of
    the flat vector; the card runs the elementwise update in parallel
    already, so this is Adam under its name."""


class Adagrad(OptimMethod):
    """Adagrad: ``accum += g^2``, ``p -= lr * g / (sqrt(accum) + eps)``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, epsilon: float = 1e-10):
        sched = Default(learning_rate_decay) if learning_rate_decay else None
        super().__init__(learning_rate, sched, weight_decay)
        self.epsilon = epsilon

    def init_state(self, params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        for k in _keys(params):
            g, a = grads[k], state["accum"][k]
            a.copy_(a + g * g)
            params[k].sub_(lr * g / (torch.sqrt(a) + self.epsilon))


class Adadelta(OptimMethod):
    """Adadelta (lr 1): ``accum`` of g^2 and ``accum_update`` of the
    steps, both decayed by ``decay_rate``."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10,
                 weight_decay: float = 0.0):
        super().__init__(1.0, None, weight_decay)
        self.rho = decay_rate
        self.epsilon = epsilon

    def init_state(self, params):
        return {"accum": _zeros_like(params),
                "accum_update": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        rho, eps = self.rho, self.epsilon
        for k in _keys(params):
            g, a, au = grads[k], state["accum"][k], state["accum_update"][k]
            a.copy_(rho * a + (1 - rho) * g * g)
            delta = g * torch.sqrt(au + eps) / torch.sqrt(a + eps)
            au.copy_(rho * au + (1 - rho) * delta * delta)
            params[k].sub_(lr * delta)


class Adamax(OptimMethod):
    """Adamax: ``u = max(beta2 * u, |g| + eps)``, ``p -= lr / (1 -
    beta1^t) * m / u``.  ``epsilon`` defaults to the reference's 1e-38, a
    subnormal f32 value that torch keeps (on the CPU and on the card) as
    BigDL's JVM does, so a weight whose gradient is exactly 0 takes a
    step of 0 (XLA on the CPU flushes it to 0 and divides 0 by 0)."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, None, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        b1, b2 = self.beta1, self.beta2
        bc = 1 - b1 ** (step + 1)
        for k in _keys(params):
            g, m, u = grads[k], state["m"][k], state["u"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            u.copy_(torch.maximum(b2 * u, torch.abs(g) + self.epsilon))
            params[k].sub_((lr / bc) * m / u)


class RMSprop(OptimMethod):
    """RMSprop: ``accum = rho * accum + (1 - rho) * g^2``, ``p -= lr * g /
    (sqrt(accum) + eps)``."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        sched = Default(learning_rate_decay) if learning_rate_decay else None
        super().__init__(learning_rate, sched, weight_decay)
        self.rho = decay_rate
        self.epsilon = epsilon

    def init_state(self, params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        rho, eps = self.rho, self.epsilon
        for k in _keys(params):
            g, a = grads[k], state["accum"][k]
            a.copy_(rho * a + (1 - rho) * g * g)
            params[k].sub_(lr * g / (torch.sqrt(a) + eps))


class Ftrl(OptimMethod):
    """FTRL-proximal (the Wide&Deep recommender's optimizer): ``accum``
    (n) starts at ``initial_accumulator_value``, ``linear`` (z) at 0.  At
    ``n = 0`` (zero padding of a resharded grad_sync bucket) the power
    ``n ** -learning_rate_power`` is taken as the reference takes it."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0,
                 l2_shrinkage_regularization_strength: float = 0.0):
        super().__init__(learning_rate, None, 0.0)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength
        self.l2_shrinkage = l2_shrinkage_regularization_strength

    def init_state(self, params):
        return {"accum": _like(params,
                               lambda p: torch.full_like(p, self.init_accum)),
                "linear": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        l1, l2, power = self.l1, self.l2, -self.lr_power
        # the card divides by a Python scalar as a multiplication by its
        # reciprocal, the CPU truly divides; a weight's step here can be a
        # few dozen ulps of the weight, where that ulp is a percent of the
        # step, so both devices multiply by the one reciprocal
        inv_lr = 1.0 / lr
        for k in _keys(params):
            p, g = params[k], grads[k]
            n, z = state["accum"][k], state["linear"][k]
            g_shrunk = g + 2 * self.l2_shrinkage * p
            n_new = n + g * g
            root_new = torch.pow(n_new, power)
            sigma = (root_new - torch.pow(n, power)) * inv_lr
            z.copy_(z + g_shrunk - sigma * p)
            p.copy_(torch.where(
                torch.abs(z) > l1,
                -(z - torch.sign(z) * l1) / (root_new * inv_lr + 2 * l2),
                torch.zeros_like(z)))
            n.copy_(n_new)


def _flat(tree: Tensors) -> torch.Tensor:
    """``tree``'s tensors as one f32 vector, in the reference's leaf order:
    a dict's keys sorted (``'.'`` sorts before every character of a name,
    so a sort of dotted names is the reference's nested sort), a list in
    order."""
    leaves = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) \
        else list(tree)
    return torch.cat([t.reshape(-1).float() for t in leaves])


def _unflat_into(tree: Tensors, flat: torch.Tensor) -> None:
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    off = 0
    for k in keys:
        t = tree[k]
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


class LBFGS(OptimMethod):
    """Limited-memory BFGS, in two modes as in the reference:

    - in the training loop, :meth:`update` runs the two-loop recursion over
      a fixed ``history`` of (s, y) pairs kept in the state as ``(history,
      n)`` matrices and steps ``lr`` along it (no line search: a
      stochastic step has no loss to re-evaluate).  A pair is pushed only
      when its curvature ``s.y`` exceeds 1e-10; ``pairs`` counts the
      pushed ones, ``count`` the steps.  Every branch is a device select,
      so the update never syncs with the host;
    - full-batch, :meth:`minimize` with the Wolfe line search.

    The flat vector is the parameters in the reference's leaf order
    (:func:`_flat`), so a state crosses packages.  Its state does not
    mirror the parameters: ``DistriOptimizer`` runs it on
    ``parameter_sharding=False`` only."""

    def __init__(self, learning_rate: float = 1.0, history: int = 10,
                 weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.history = history

    def init_state(self, params):
        flat = _flat(params)
        n, m = flat.shape[0], self.history
        z = dict(device=flat.device, dtype=torch.float32)
        i32 = dict(device=flat.device, dtype=torch.int32)
        return {"s": torch.zeros((m, n), **z), "y": torch.zeros((m, n), **z),
                "rho": torch.zeros((m,), **z),
                "prev_flat": torch.zeros((n,), **z),
                "prev_grad": torch.zeros((n,), **z),
                "count": torch.zeros((), **i32),
                "pairs": torch.zeros((), **i32)}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        flat, g = _flat(params), _flat(grads)
        m = self.history
        st = state
        s_new = flat - st["prev_flat"]
        y_new = g - st["prev_grad"]
        ys = torch.dot(s_new, y_new)
        have = (st["count"] > 0) & (ys > 1e-10)
        # push the previous step's pair where its curvature is positive
        st["s"].copy_(torch.where(
            have, torch.cat([st["s"][1:], s_new[None]]), st["s"]))
        st["y"].copy_(torch.where(
            have, torch.cat([st["y"][1:], y_new[None]]), st["y"]))
        st["rho"].copy_(torch.where(
            have, torch.cat([st["rho"][1:], (1.0 / ys)[None]]), st["rho"]))
        st["pairs"].add_(have.to(torch.int32))
        n_pairs = torch.clamp(st["pairs"], max=m)
        s_h, y_h, rho = st["s"], st["y"], st["rho"]
        zero = torch.zeros((), device=flat.device)
        # two-loop recursion over the newest n_pairs pairs (ring order)
        q = g
        alphas = [zero] * m
        for i in range(m):
            ix = m - 1 - i
            alpha = torch.where(i < n_pairs,
                                rho[ix] * torch.dot(s_h[ix], q), zero)
            q = q - alpha * y_h[ix]
            alphas[ix] = alpha
        alphas = torch.stack(alphas)
        yy = torch.dot(y_h[-1], y_h[-1])
        gamma = torch.where(n_pairs > 0, torch.dot(s_h[-1], y_h[-1])
                            / torch.clamp(yy, min=1e-10),
                            torch.ones((), device=flat.device))
        r = gamma * q
        for i in range(m):
            valid = i < n_pairs
            # past the pairs the index is clamped (its term is selected
            # away); index_select keeps the index on the device
            ix = torch.clamp(m - n_pairs + i, max=m - 1).long().reshape(1)
            s_i, y_i = s_h.index_select(0, ix)[0], y_h.index_select(0, ix)[0]
            beta = torch.where(valid, rho.index_select(0, ix)[0]
                               * torch.dot(y_i, r), zero)
            r = r + torch.where(valid, alphas.index_select(0, ix)[0] - beta,
                                zero) * s_i
        _unflat_into(params, flat - lr * r)
        st["prev_flat"].copy_(flat)
        st["prev_grad"].copy_(g)
        st["count"].add_(1)

    def minimize(self, feval, params, max_iter: int = 100,
                 tol_grad: float = 1e-5, c1: float = 1e-4, c2: float = 0.9,
                 max_ls: int = 20):
        """Deterministic full-batch L-BFGS with the Wolfe line search (the
        reference's ``lswolfe`` conditions).  ``feval(params) -> (loss,
        grads)`` takes and returns ``params``'s structure (a dict or list
        of tensors).  Returns ``(params, final loss, iterations)``; the
        host reads the loss and the line search's tests each iteration."""
        keys = sorted(params) if isinstance(params, dict) \
            else range(len(params))
        shapes = [(k, params[k].shape, params[k].numel()) for k in keys]

        def unflat(x):
            out = {} if isinstance(params, dict) else [None] * len(shapes)
            off = 0
            for k, shape, n in shapes:
                out[k] = x[off:off + n].view(shape)
                off += n
            return out

        def fe(x):
            loss, grads = feval(unflat(x))
            return loss, _flat(grads)

        flat = _flat(params).detach()
        loss, g = fe(flat)
        s_hist, y_hist, rho_hist = [], [], []
        it = 0
        for it in range(1, max_iter + 1):
            if float(torch.max(torch.abs(g))) < tol_grad:
                break
            q = g
            alphas = []
            for s, y, rho in zip(reversed(s_hist), reversed(y_hist),
                                 reversed(rho_hist)):
                a = rho * torch.dot(s, q)
                alphas.append(a)
                q = q - a * y
            if s_hist:
                gamma = (torch.dot(s_hist[-1], y_hist[-1])
                         / torch.clamp(torch.dot(y_hist[-1], y_hist[-1]),
                                       min=1e-10))
            else:
                gamma = 1.0
            r = gamma * q
            for (s, y, rho), a in zip(zip(s_hist, y_hist, rho_hist),
                                      reversed(alphas)):
                b = rho * torch.dot(y, r)
                r = r + (a - b) * s
            d = -r
            gtd = float(torch.dot(g, d))
            if gtd > -1e-12:  # not a descent direction: reset
                d = -g
                gtd = float(torch.dot(g, d))
                s_hist, y_hist, rho_hist = [], [], []
            t = 1.0
            f0 = float(loss)
            ok = False
            best_t, best_f = 0.0, f0
            loss_t = g_t = None
            for _ in range(max_ls):
                loss_t, g_t = fe(flat + t * d)
                f_t = float(loss_t)
                if f_t < best_f:
                    best_t, best_f = t, f_t
                if f_t > f0 + c1 * t * gtd:
                    t *= 0.5  # Armijo failed: backtrack
                elif float(torch.dot(g_t, d)) < c2 * gtd:
                    t = min(t * 2.1, 1e4)  # curvature failed: extend
                else:
                    ok = True
                    break
            if ok:
                new_flat, loss_n, g_n = flat + t * d, loss_t, g_t
            else:
                # the best evaluated point, as lswolfe falls back to it
                if best_t == 0.0:
                    break
                t = best_t
                new_flat = flat + t * d
                loss_n, g_n = fe(new_flat)
            s_new, y_new = new_flat - flat, g_n - g
            ys = float(torch.dot(s_new, y_new))
            if ys > 1e-10:
                s_hist.append(s_new)
                y_hist.append(y_new)
                rho_hist.append(1.0 / ys)
                if len(s_hist) > self.history:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho_hist.pop(0)
            flat, loss, g = new_flat, loss_n, g_n
        return unflat(flat), float(loss), it
