"""Training: one step of the port's loss, its backward and
``torch.optim.Adam``, the loss on the host.

Set-up builds the model and its optimizer once, drives them through
their first three steps by the window's own call, on three different
batches of the pool, and hands the same objects to the window. Check: the
plain reference in float64 follows the same three steps from the same
weights. ``loss_gap`` is the worst step's loss gap relative to the
reference's; ``grad_gap`` the worst leaf's gap between the norms of the
first gradient (read back from Adam's first moment after one step) and
the reference's; ``update_gap`` the same of the parameters' change over
the three steps. A leaf whose reference gradient is under a thousandth of
the median leaf's moves by rounding alone and is left out of
``update_gap``; each gap is over the larger of the reference leaf's norm
and the median leaf's.
"""

import statistics

import torch

from .. import harness
from ..reference.tf32 import exact_matmul, tf32_matmul
from .common import leaf_gap, worst

CHECKED_STEPS = 3


class ProgramTrainer:
    """The port's model under ``torch.optim.Adam``."""

    def __init__(self, model, loss_fn, lr, span):
        self.model, self.loss_fn, self.span = model, loss_fn, span
        self.opt = torch.optim.Adam(model.parameters(), lr=lr)

    def step(self, batch):
        obs, lengths = batch
        self.opt.zero_grad(set_to_none=True)
        with self.span("model"):
            loss = self.loss_fn(self.model, obs, lengths)
        with self.span("backward"):
            loss.backward()
        with self.span("optimizer.step"):
            self.opt.step()
        with self.span("to_host"):
            return loss.detach().cpu()

    def leaves(self):
        return dict(self.model.named_parameters())

    def first_grad(self):
        """The first moment over ``1 - beta1``: after one step, the
        gradient the optimizer got (zero where it holds none)."""
        b1 = self.opt.defaults["betas"][0]
        return {k: self.opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1.0 - b1)
                for k, p in self.leaves().items()}


class Session(harness.Session):
    def __init__(self, fam, cfg, traffic, seed, device):
        super().__init__(fam, cfg, traffic, seed, device)
        self.trainer = ProgramTrainer(self.model, fam.program_loss, traffic["lr"],
                                      lambda name: self.span(name))

    def warm(self):
        leaves = self.trainer.leaves()
        p0 = {k: v.detach().clone() for k, v in leaves.items()}
        self.losses = []
        for i in range(CHECKED_STEPS):
            self.losses.append(float(self.call(i)))
            if i == 0:
                self.g1 = {k: v.detach().clone() for k, v in self.trainer.first_grad().items()}
        self.delta = {k: leaves[k].detach() - p0[k] for k in p0}
        n = self.traffic["warm_calls"]
        for i in range(CHECKED_STEPS, n):
            self.call(i)
        self.next_call = n

    def call(self, i):
        return self.trainer.step(self.pool.batch(i))

    def keep(self, n, i, result):
        pass

    def free(self):
        self.trainer = None
        super().free()

    def judge(self):
        ref = self.fam.reference_trainer(self.cfg, self.w, self.traffic["lr"], torch.float64,
                                         self.device, exact_matmul)
        p0 = {k: v.detach().clone() for k, v in ref.leaves().items()}
        losses = []
        for i in range(CHECKED_STEPS):
            losses.append(float(ref.step(self.pool.batch(i))))
        g1 = ref.first_grad()
        delta = {k: ref.leaves()[k].detach() - p0[k] for k in p0}
        self.details = {k: {"grad": [float(self.g1[k].double().norm()), float(g1[k].norm())],
                            "change": [float(self.delta[k].double().norm()),
                                       float(delta[k].norm())]} for k in g1}
        gn = {k: float(g.norm()) for k, g in g1.items()}
        med = statistics.median(gn.values())
        moved = {k for k, v in gn.items() if v >= 1e-3 * med}
        return {
            "loss_gap": worst(abs(a - b) / abs(b) for a, b in zip(self.losses, losses)),
            "grad_gap": leaf_gap(self.g1, g1),
            "update_gap": leaf_gap(self.delta, delta, keep=moved),
        }


def control(session, matmul=tf32_matmul):
    """Put the plain reference in float32 with TF32 products (or with the
    products ``matmul`` gives), and its Adam, in the program's place."""
    session.trainer = session.fam.reference_trainer(
        session.cfg, session.w, session.traffic["lr"], torch.float32, session.device, matmul)
