"""Plain float32 references of the port's training objectives.

A configuration names its reference in ``configs/<config>.json`` under the
top-level key ``"reference"``, as ``"<module>.<Class>"`` of this package
(``"depth.DepthReference"``); without the key it is
``"joint.JointReference"``. The harness resolves the name
(``harness.load_cell``) and builds the class for the weights' shapes, the
FLOP count and the check (``step.reference_steps``). Every reference class
keeps to one contract:

- ``Class(cfg: dict, fake_quant=None)``: ``cfg`` is the configuration
  file's ``"config"``; a setting the class does not implement raises
  ``NotImplementedError``. ``fake_quant``, when given, rounds the frames and
  every convolution's and dense layer's inputs, weights and outputs (the
  control's lower precision, ``step.fp8_fake_quant``).
- ``loss_pack(images, K_ms, K_inv_ms, calls=None)``: the loss pack of one
  batch (uint8 stacks [B, 3H, W, 3], K and K^-1 pyramids [B, S, 3, 3]), a
  dict of [B] vectors under the port's loss names. ``calls``
  (``flops.KernelCalls``), when given, records each call of a kernel's
  function with the frozen formulas (``flops.counted``).
- ``weights()``: {loss name: its weight in the step's loss}.
- its parameters and buffers are named as in the port's ``state_dict``, and
  they name every parameter of the port's model (a network the objective
  does not run is held all the same, and takes no gradient), so that one
  set of weights, keyed by name, loads into both.
- plain float32 ``torch``, importing nothing of the port or of JAX.
"""
