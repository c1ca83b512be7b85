"""The CLU training step as ``train-clu``'s loop calls it:
``build_training(model, True, trainable_predicate(), lr, device)``, then
``steps.train_step(*batch_to_device(batch, device))`` on loader batches
cycled from a seeded pool, the losses left on the device and read after
the window.

Set-up builds the one step object, drives it through its first
``checked_steps`` steps on the pool's first batches (rows that all differ)
and hands the same object to the window.  Once the window has closed, the
state is saved and the same object takes one more step.  The tower is
frozen: the reference follows the decoder's training from the program's
own taps of each batch (its frozen tower's, taken after the window), so
that the tower's rounding does not hide what the training step does, and
checks that start by itself, the program's taps against its own tower's
(``tower_gap``).  Compared are each step's loss, each trained leaf's
gradient as Adam got it (from its first moment), and each leaf's and
BatchNorm statistic's change, by the worst leaf: over the checked steps
from the raw weights, and over the last step from the saved state.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.common.inputs import train_pool
from portbench.drivers import Driver as Base
from portbench.drivers import TapGap, nchw, on
from portbench.reference.heads import CLU_TAPS
from portbench.reference.train import BETA1, stat_keys, trainable_keys

#: A leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by round-off alone: left out of the change.
STILL = 1e-3


def norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]):
    """Each leaf's gap between the program's and the reference's norm, as
    a share of the larger of the reference's norm of that leaf and of the
    median leaf's."""
    norms = {k: norm(v) for k, v in want.items()}
    median = median_of(list(norms.values()))
    out = []
    for k, w in norms.items():
        g = norm(got[k]) if k in got else math.inf
        out.append(abs(g - w) / max(w, median, 1e-30)
                   if math.isfinite(g) else math.inf)
    return out


def median_of(values):
    return sorted(values)[len(values) // 2]


def host(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in d.items()}


class Driver(Base):

    latency = False
    decodes = False

    def setup(self) -> None:
        t, m = self.traffic, self.model
        self.batch, self.lr = t["batch"], t["lr"]
        self.n_checked = t["checked_steps"]
        self.pool = train_pool(self.seed, t["pool_batches"], self.batch,
                               m.image_size(self.cfg), m.Reference.mean,
                               m.Reference.std, self.device, t["regions"])
        self.lap("inputs")
        n = t["settle_pairs"]
        (a, b), _ = self.pool[0][0]
        sd = self.draw_weights(lambda: [
            torch.as_tensor(x[:n]).to(self.device).permute(0, 3, 1, 2)
            for x in (a, b)])
        self.lap("weights")
        self.losses, self.steps_done = [], 0
        if self.control:
            return
        from srsem_torch.train.loop import batch_to_device, build_training
        from srsem_torch.train.partition import trainable_predicate

        _, model = m.build(self.cfg, sd, self.device)
        del sd
        self.steps, self.optimizer = build_training(
            model, True, trainable_predicate(), self.lr, self.device)
        self.to_device = batch_to_device
        self.model_obj = model
        self.names = {id(p): k for k, p in model.named_parameters()}
        self.lap("program")
        self.checked_losses, self.first_grads = [], {}
        for i in range(self.n_checked):
            self.checked_losses.append(self.step(i))
            if i == 0:
                self.first_grads = {k: v / (1 - BETA1) for k, v in
                                    self.moments("exp_avg").items()}
        self.lap("checked_steps")
        self.after = self.leaves_and_stats()

    def moments(self, key: str) -> Dict[str, torch.Tensor]:
        return {self.names[id(p)]: s[key].detach().clone()
                for p, s in self.optimizer.state.items()}

    def leaves_and_stats(self) -> Dict[str, torch.Tensor]:
        state = self.model_obj.state_dict()
        return {k: state[k].detach().clone()
                for k in trainable_keys(self.sd_host) + stat_keys(self.sd_host)}

    def step(self, i: int) -> torch.Tensor:
        self.steps_done += 1
        batch = self.pool[i % len(self.pool)]
        return self.steps.train_step(*self.to_device(batch, self.device))

    def call(self, i: int) -> None:
        if not self.control:  # the control's readings need no window
            self.losses.append(self.step(self.n_checked + i))

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def min_calls(self) -> int:
        return 1

    @property
    def items_per_call(self) -> int:
        return self.batch

    def tower_passes(self):
        return [2 * self.batch]

    def work(self):
        return {"tower": 2 * self.batch, "train_pair": self.batch}

    def device_batch(self, i: int):
        (((a, b), y), mask) = self.pool[i % len(self.pool)]
        return [torch.as_tensor(v).to(self.device) for v in (a, b, y, mask)]

    def free(self) -> None:
        """After the window: the last step from a saved state, and the
        taps of the checked batches and of the last one; then let the
        program go."""
        self.failed = sum(not math.isfinite(float(v)) for v in self.losses)
        if self.control:
            ref = self.reference(control=self.control)
            self.kept = [self.ref_taps(ref, i) for i in range(self.n_checked)]
            return
        self.checked_losses = [float(v) for v in self.checked_losses]
        self.first_grads, self.after = host(self.first_grads), host(self.after)
        pre = {"leaves": host(self.leaves_and_stats()), "t": 0}
        pre["stats"] = pre["leaves"]
        if self.optimizer.state:  # Adam has stepped
            pre.update(t=int(max(float(s["step"]) for s in
                                 self.optimizer.state.values())),
                       m=host(self.moments("exp_avg")),
                       v=host(self.moments("exp_avg_sq")))
        self.last_batch = self.steps_done
        loss = float(self.step(self.last_batch))
        m_after = host(self.moments("exp_avg"))
        post = host(self.leaves_and_stats())
        self.last = {"pre": pre, "got": {
            "losses": [loss],
            "grads": {k: (m_after[k] - BETA1 * pre.get("m", m_after)[k])
                      / (1 - BETA1) for k in pre.get("m", {})},
            "leaves": post, "stats": post}}
        tower = self.model.frozen_tower(self.model_obj)
        with torch.no_grad():
            self.kept = [self.program_taps(tower, i) for i in
                         list(range(self.n_checked)) + [self.last_batch]]
        self.steps = self.optimizer = self.model_obj = None

    def program_taps(self, tower, i: int):
        a, b, _, _ = self.device_batch(i)
        n = a.shape[0]
        taps = nchw(tower(torch.cat([a, b]))[1], CLU_TAPS)
        return ({k: v[:n] for k, v in taps.items()},
                {k: v[n:] for k, v in taps.items()})

    def ref_taps(self, ref, i: int):
        a, b, _, _ = self.device_batch(i)
        with torch.no_grad():
            return tuple(host(ref.tower(x.permute(0, 3, 1, 2)))
                         for x in (a, b))

    def batches(self, idx, taps):
        """``((taps_a, taps_b), y, mask)`` on the device for pool batches
        ``idx`` and the host taps ``taps``."""
        out = []
        for i, (ta, tb) in zip(idx, taps):
            _, _, y, mask = self.device_batch(i)
            out.append(((on(self.device, ta), on(self.device, tb)), y, mask))
        return out

    def program(self) -> dict:
        """The program's readings over the checked steps, in the
        reference's form."""
        return {"losses": self.checked_losses, "grads": self.first_grads,
                "leaves": {k: self.after[k] for k in
                           trainable_keys(self.sd_host)},
                "stats": {k: self.after[k] for k in stat_keys(self.sd_host)}}

    def compare(self, got: dict, want: dict, start=None) -> dict:
        """The three numbers of ``got`` against ``want``; changes are
        taken from ``start`` (leaves and statistics), or the raw
        weights."""
        base = start or self.sd_host
        p0 = {k: base[k].to(self.device)
              for k in list(want["leaves"]) + list(want["stats"])}
        gn = {k: norm(v) for k, v in want["grads"].items()}
        median = median_of(list(gn.values()))
        moved = [k for k, v in gn.items() if v >= STILL * median]
        change = lambda r, k: r[k].to(p0[k].device) - p0[k]  # noqa: E731
        got_change = {k: change(got["leaves"], k) for k in moved}
        want_change = {k: change(want["leaves"], k) for k in moved}
        for k in want["stats"]:
            got_change[k] = change(got["stats"], k)
            want_change[k] = change(want["stats"], k)
        loss = max(abs(g - w) / abs(w) for g, w in
                   zip(got["losses"], want["losses"]))
        grads = {k: v.to(self.device) for k, v in got["grads"].items()}
        return {"loss_gap": loss if math.isfinite(loss) else math.inf,
                "grad_gap": max(leaf_gaps(grads, want["grads"])),
                "change_gap": max(leaf_gaps(got_change, want_change))}

    def check(self) -> dict:
        idx = list(range(self.n_checked))
        checked = self.batches(idx, self.kept[:self.n_checked])
        ref = self.reference()
        want = ref.train(checked, self.lr)
        if self.control:
            got = self.reference(control=self.control).train(checked, self.lr)
        else:
            got = self.program()
        numbers = self.compare(got, want)
        if not self.control:
            pre = self.last["pre"]
            start = {k: {n: v.to(self.device) for n, v in d.items()}
                     for k, d in pre.items() if k != "t"}
            start["t"] = pre["t"]
            last = self.batches([self.last_batch], self.kept[-1:])
            want_last = ref.train(last, self.lr, start=start)
            for k, v in self.compare(self.last["got"], want_last,
                                     pre["leaves"]).items():
                numbers[k] = max(numbers[k], v)
        towers = TapGap()
        for i in idx:
            pa, pb = self.kept[i]
            ra, rb = self.ref_taps(ref, i)
            towers.offer(pa, ra)
            towers.offer(pb, rb)
        numbers["tower_gap"] = towers.value()
        return numbers

    def reference_batches(self):
        """The checked batches on the reference's own taps (the readings
        of a planted fault)."""
        ref = self.reference()
        idx = list(range(self.n_checked))
        return self.batches(idx, [self.ref_taps(ref, i) for i in idx])
