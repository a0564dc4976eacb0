"""The user's recipes: the programs through which the system is trained and
evaluated end to end, each run as `python -m swinwnet_tpu_torch.recipes.<name>`
with the flags, defaults and output files of its JAX counterpart.

quality_run          train the three supervised stages on synthetic crystals,
                     run the published eval protocol, write the results in
                     the published schema and a checkpoint
quality_continue     continue stages 2 and 3 from a quality checkpoint
rl_run               the REINFORCE fine-tune from a quality checkpoint, with
                     the constant-gain ablation
classical_baselines  the bilinear and pooling baselines through the same
                     physics
train_synthetic      a miniature of the whole lifecycle on synthetic data

Each runs on the card unless given `--device cpu`; `--fused-blocks` sends the
levels the gate admits through the fused Swin-block kernel.
"""
