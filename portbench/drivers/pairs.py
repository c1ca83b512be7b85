"""Closed-loop pair scoring with one caller: ``PairScorer.score_arrays`` on
``batch`` (GT, SR) uint8 host arrays drawn in turn from a seeded pool, the
result (scores, or maps for a CLU model) brought to the host every call,
as ``score_paths`` does.

After the window a seeded sample of the window's results is compared
with the reference: the head or decoder alone (the model's
``STAGE_GAP``), the reference's run on the program's own taps of the same
inputs, so that the rounding of the tower does not hide the precision of
what follows; that start by itself, the program's taps against the
reference's (``tower_gap``); and where the model names one (``GAP``), the
whole chain from the uint8 inputs.  The program's taps are its tower's
on the sampled calls' inputs, whole batches as the window ran them,
taken once the window has closed: the frozen tower gives the window's
taps again, which the stage's gap reads (a tap off by a last place moves
a map by far more than the decoder's own rounding)."""

from __future__ import annotations

import torch

from portbench.common.inputs import pair_pool
from portbench.drivers import Driver as Base
from portbench.drivers import TapGap, finite_gap, in_chunks, nchw, on


class Driver(Base):

    def setup(self) -> None:
        t, m = self.traffic, self.model
        self.batch = t["batch"]
        self.batches = t["pool"] // self.batch
        self.gt, self.sr = pair_pool(self.seed, t["pool"], m.image_size(self.cfg),
                                     t["noise"], self.device)
        self.lap("inputs")
        n = t["settle_pairs"]
        sd = self.draw_weights(lambda: self.normalized(self.gt[:n], self.sr[:n]))
        self.lap("weights")
        if self.control:
            ref = m.Reference(self.cfg, sd, control=self.control)
            self.fn = lambda a, b: self.ref_outputs(ref, a, b)
            self.tower = lambda x: self.ref_taps(ref, x)
        else:
            from srsem_torch.eval.scorer import PairScorer

            pcfg, model = m.build(self.cfg, sd, self.device)
            self.scorer = PairScorer(pcfg, model, batch_size=self.batch,
                                     model_kind=m.KIND, device=self.device)
            self.fn = lambda a, b: self.scorer.score_arrays(a, b).cpu()
            names = m.tap_names(self.cfg)
            self.tower = lambda x: nchw(self.scorer.tower(
                self.scorer.normalize(x))[1], names)
        del sd
        self.lap("program")
        for i in range(t["warmup_calls"]):
            self.fn(*self.inputs(i))
        self.lap("warmup")

    def inputs(self, j: int):
        j %= self.batches
        s = slice(j * self.batch, (j + 1) * self.batch)
        return self.gt[s], self.sr[s]

    def call(self, i: int) -> None:
        self.reservoir.offer((i, self.fn(*self.inputs(i))))

    @property
    def items_per_call(self) -> int:
        return self.batch

    def tower_passes(self):
        return [self.batch, self.batch]

    def work(self):
        return {"tower": 2 * self.batch, "pair": self.batch}

    def free(self) -> None:
        """Keep the program's taps of the sampled calls' inputs on the
        host, then let the program go."""
        with torch.inference_mode():
            self.kept = {i: tuple(self.tower(x) for x in self.inputs(i))
                         for i, _ in self.reservoir.items}
        self.scorer = self.fn = self.tower = None

    def ref_outputs(self, ref, a, b):
        chunk = self.traffic["check_chunk"]

        def one(x, y):
            xa = torch.as_tensor(x).to(self.device)
            xb = torch.as_tensor(y).to(self.device)
            return ref.head(ref.taps(xa), ref.taps(xb))

        with torch.no_grad():
            return in_chunks(one, len(a), chunk, a, b)

    def ref_taps(self, ref, x):
        """The control's taps of host images on the host, in the blocks
        its outputs were computed in."""
        step = self.traffic["check_chunk"]
        parts = [ref.taps(torch.as_tensor(x[j:j + step]).to(self.device))
                 for j in range(0, len(x), step)]
        return {k: torch.cat([p[k].cpu() for p in parts]) for k in parts[0]}

    def check(self) -> dict:
        ref, dev, m = self.reference(), self.device, self.model
        step = self.traffic["check_chunk"]
        got, whole, stage, towers = [], [], [], TapGap()
        with torch.no_grad():
            for i, out in self.reservoir.items:
                got.append(out.float())
                (a, b), (ka, kb) = self.inputs(i), self.kept[i]
                for j in range(0, len(a), step):
                    rows = slice(j, j + step)
                    ra = ref.taps(torch.as_tensor(a[rows]).to(dev))
                    rb = ref.taps(torch.as_tensor(b[rows]).to(dev))
                    if m.GAP:
                        whole.append(ref.head(ra, rb).cpu())
                    pa = on(dev, {k: v[rows] for k, v in ka.items()})
                    pb = on(dev, {k: v[rows] for k, v in kb.items()})
                    stage.append(ref.head(pa, pb).cpu())
                    towers.offer(pa, ra)
                    towers.offer(pb, rb)
        got = torch.cat(got)
        numbers = {m.STAGE_GAP: finite_gap(m.gap(got, torch.cat(stage)), got),
                   "tower_gap": towers.value()}
        if m.GAP:
            numbers[m.GAP] = finite_gap(m.gap(got, torch.cat(whole)), got)
        return numbers
