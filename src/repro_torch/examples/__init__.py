"""The reference's four example scripts as modules of the port.

Each runs as ``python -m repro_torch.examples.<name>`` on the CUDA
device by default (``--device cpu`` runs the host kernel instead; asking
for CUDA without a card raises), at the reference script's own sizes:

  quickstart               B1 at 60^3: energy balance, axial decay
                           against diffusion theory, on-axis fluence
  source_gallery           every source of ``sources.demo_menu`` on B1:
                           energy balance and an ASCII exitance map
  heterogeneous_lb         pilot fit, S1/S2/S3, a run over every local
                           device, the dynamic chunk scheduler
  fault_tolerant_campaign  a chaos drill, then a crash and a restart
                           from checkpoints, each bit-identical to the
                           clean run

Each module's ``run(...)`` returns the numbers its ``main(argv)``
prints.  The multi-device paths start a process a device (spawn), so
all work sits behind each module's ``if __name__ == "__main__":``.

The reference's scripts run one segment a round (``SimConfig``'s
default K = 1); these run ``STEPS_PER_ROUND``, the K of the port's main
paths on the card.  The results are the same bits at any K (a photon's
path depends only on the seed and its id, and every total is an int64
sum); only the round count and ``steps`` change.  At K = 1 each round
is a kernel launch and ~180 host-issued operations, and the four
examples took 569 s on one H100 at 700 W (``chip_smoke.py``'s examples
phase).
"""

STEPS_PER_ROUND = 16
