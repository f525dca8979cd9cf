"""Faults planted in the port underneath a run, which the output check has
to refuse: the program's object is patched after the session builds it
and before set-up drives it.

* ``half_batch``: half of the batch left out (decode: the second half's
  rows are never decoded and come back zero; training: the loss is the
  mean over the first half's rows alone);
* ``altered``: an answer altered where it is produced (decode: one state
  of the first row's path, mid-way through its valid frames);
* ``unchanged``: a training step that returns its state unchanged (the
  optimizer's update skipped).

The cells run on one card, so no exchange between cards can be left out.
"""


FAULTS = {"decode": ("half_batch", "altered"), "train": ("half_batch", "unchanged")}


def plant(session, fault: str) -> None:
    entry = session.traffic["entry"]
    if fault not in FAULTS[entry]:
        raise ValueError(f"{entry} cells have no fault {fault!r}")
    model = session.model
    if entry == "decode":
        forward = model.forward

        def broken(obs, *args, **kw):
            states, score = forward(obs, *args, **kw)
            states, score = states.clone(), score.clone()
            if fault == "half_batch":
                h = obs.shape[0] // 2
                states[h:] = 0
                score[h:] = 0
            else:
                lengths = kw.get("lengths", args[-1] if args else None)
                t = int(lengths[0]) // 2
                states[0, t] = (states[0, t] + 1) % session.cfg["num_states"]
            return states, score

        model.forward = broken
    elif fault == "half_batch":
        loss = model.compute_loss

        def broken(obs, lengths=None):
            h = obs.shape[0] // 2
            return loss(obs[:h], None if lengths is None else lengths[:h])

        model.compute_loss = broken
    else:
        session.trainer.opt.step = lambda *a, **k: None

