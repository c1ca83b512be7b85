"""Closed-loop pair scoring on a token tower: the ``pairs`` driver (its
inputs, loop, sample and checks), keeping the program's ``(N, T, W)``
token taps on the host as they are, where ``pairs`` turns NHWC taps
into NCHW."""

from __future__ import annotations

from portbench.drivers import pairs


def on_host(taps, names):
    """The program's taps ``names`` on the host, in their dtype."""
    return {k: taps[k].cpu() for k in names}


class Driver(pairs.Driver):

    def setup(self) -> None:
        super().setup()
        if not self.control:
            names = self.model.tap_names(self.cfg)
            self.tower = lambda x: on_host(self.scorer.tower(
                self.scorer.normalize(x))[1], names)
