"""Plain PyTorch references of the benchmark's model families.

Each module follows the model's published equations with plain tensor
operations, imports nothing of the port, and takes only the weights and
inputs that the benchmark makes from the seed. Run in float64 they are
the judge of a cell's output; run in float32 with TF32 products
(:mod:`.tf32`) they are the control that the judge must refuse.
"""
