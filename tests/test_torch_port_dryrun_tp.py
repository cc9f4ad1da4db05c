"""tools/dryrun_multichip_torch.py, the port's counterpart of the micro part
of `__graft_entry__.py::dryrun_multichip`, on the CPU: 4 gloo ranks (a 2 x 2
grid), one thread each, one training step of the dry run's micro config.
Its coverage line counts what the JAX dry run's counts on the same config:
the JAX rule at min_dim 256 on `jax.eval_shape` of the JAX trainer's state,
plus the one in_proj."""

import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_coverage():
    """(column, row, leaves) of the JAX dry run's shardings on its micro
    config: `params_shardings` at min_dim 256 of params and text_params,
    one in_proj added by columns."""
    import __graft_entry__
    from jax.sharding import PartitionSpec as P

    from uni_encoder_tpu.parallel.mesh import param_spec
    from uni_encoder_tpu.training.train_step import Trainer

    cfg = __graft_entry__._tiny_config()
    B, H = 2, 32
    seg = {"images": jnp.zeros((B, H, H, 3)), "task_tokens": jnp.ones((B, 77), jnp.int32),
           "text_tokens": jnp.ones((B, 6, 77), jnp.int32), "labels": jnp.zeros((B, 4), jnp.int32),
           "masks": jnp.zeros((B, 4, H // 4, H // 4), bool), "valid": jnp.ones((B, 4), bool)}
    K = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))
    seq = {"images": jnp.zeros((B, H, H, 3)), "prev_images": jnp.zeros((B, H, H, 3)),
           "next_images": jnp.zeros((B, H, H, 3)), "K": K, "inv_K": K}
    shapes = jax.eval_shape(Trainer(cfg).init, jax.random.PRNGKey(0), seg, seq)
    leaves = [(tree, leaf) for tree in (shapes.params, shapes.text_params)
              for _, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    specs = [param_spec("", leaf, 256) for _, leaf in leaves]
    return (sum(s == P(None, "model") for s in specs) + 1, sum(s == P("model", None) for s in specs), len(leaves),
            sum(int(np.prod(leaf.shape)) for _, leaf in leaves))


def test_dryrun_tool_on_a_2x2_grid_of_cpu_ranks():
    """`tools/dryrun_multichip_torch.py 4 --device cpu`: exit 0; the last
    line is the JAX dry run's `dryrun_multichip(n=4, mesh=(2, 2)): loss=...`
    with finite losses; step 1 on mesh (2, 2) at 64 x 64, 1 image a data
    rank; its coverage counts (column, row, parameters, elements) are the
    JAX dry run's; collectives ran over the model group, the data group
    and the whole world (the replicated gradients' mean), each counted
    apart."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "dryrun_multichip_torch.py"), "4",
                           "--device", "cpu", "--timeout", "300"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    last = re.fullmatch(r"dryrun_multichip\(n=4, mesh=\(2, 2\)\): loss=(\S+) seg=(\S+) mono=(\S+)", lines[-1])
    assert last, lines[-1]
    assert all(math.isfinite(float(v)) for v in last.groups())
    assert any(re.match(r"step 1 on mesh \(2, 2\): global batch 2 a modality at 64x64, 1 a data rank", l)
               for l in lines), lines
    cov = next(re.match(r"TP coverage: (\d+) column-sharded \+ (\d+) row-sharded kernels of (\d+) params \((\d+) of "
                        r"(\d+) elements", l) for l in lines if l.startswith("TP coverage"))
    col, row, n, _, total = (int(v) for v in cov.groups())
    assert (col, row, n, total) == _jax_coverage()
    calls = re.search(r"model group (\d+) all-reduces, \S+ MB; data group (\d+) all-reduces, \S+ MB; "
                      r"world (\d+) all-reduces", proc.stdout)
    assert calls and all(int(v) > 0 for v in calls.groups()), proc.stdout
