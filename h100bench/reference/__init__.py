"""The plain PyTorch reference: imports nothing of the program.

A configuration names its reference family in `about.reference`, and the
harness loads `reference/<family>.py` by that name (`common.load_family`);
the kinds, the FLOP count, the weight draw and the harness's tiny-width
tests reach the reference through the family alone. A family module
exposes:

- `Net(cfg)`: the plain float32 network, its parameters under the
  program's names and shapes, so one set of seeded weights loads into both;
- `process(cfg, device)`: the reference forward process;
- `per_row_loss(net, proc, cfg, x0, gen, n_iter) -> (terms (B,), output)`:
  one rank's loss terms, whose mean is the loss, and the network's output,
  every draw from `gen` in the order the program makes it;
- `forward_flops(cfg, batch)`: the FLOPs of one forward of `Net` at `batch`;
- `shrink(cfg)`: the configuration at the tiny widths of the harness's CPU
  tests, changed in place and returned;
- optionally `weight_kinds(net) -> {leaf: "norm" | "bias" | ("fan", fan_avg)}`,
  a kind for every parameter of `net`; without it the draw takes
  `common.leaf_kinds(net)`.

What every family shares stays in `train.py` (the step's seeds and the
order of its draws, the mean over ranks, clip, Adam, EMA) and `sample.py`.
"""
