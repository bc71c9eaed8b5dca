"""Both packages' labelled-accuracy report on the same LeNet weights (CPU).

The shapes task of ``examples/accuracy_synthetic.py`` at its defaults
(10,000 training and 2,000 test images from ``--seed``, calibration on the
first 100 training images).  The LeNet twin comes from one of:

* ``--net PATH``: a state dict written by the port's example
  (``python -m int8inferenceengine_tpu_torch.examples.accuracy_synthetic
  --save-net PATH``, for instance on the card);
* the recipe (default): the port's ``train_torch_lenet`` on the CPU, which
  gives the JAX helper's net bit for bit (checked here);
* ``--order-seed N``: the same twin and steps, the batch order drawn from
  ``torch.Generator().manual_seed(N)`` instead of the recipe's stream.

Then the JAX package's ``accuracy_report`` and the port's (``--device
cpu``) run on those weights, and every leg's accuracy and drop is printed
for both, one JSON line a net.

    python tools/torch_synthetic_witness.py [--net PATH ...] [--recipe]
        [--order-seed N ...] [--n-train 10000] [--n-test 2000] [--epochs 2]
"""

import argparse
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from examples import accuracy_synthetic as jax_syn  # noqa: E402
from int8inferenceengine_tpu_torch import models  # noqa: E402
from int8inferenceengine_tpu_torch.examples import \
    accuracy_synthetic as port_syn  # noqa: E402


def report(label, net, data):
    x_train, x_test, y_test = data
    t0 = time.perf_counter()
    ref = jax_syn.accuracy_report(net, x_test, y_test, x_train[:100])
    port = port_syn.accuracy_report(net, x_test, y_test, x_train[:100],
                                    device="cpu")
    print(json.dumps({
        "net": label, "n_test": len(y_test),
        "torch_fp32": ref["torch_fp32"],
        "drop_pts_jax": {k: 100 * (ref["torch_fp32"] - v)
                         for k, v in ref.items()},
        "drop_pts_port": {k: 100 * (port["torch_fp32"] - v)
                          for k, v in port.items()},
        "images_apart": {k: round(abs(port[k] - ref[k]) * len(y_test))
                         for k in ref},
        "seconds": time.perf_counter() - t0}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", action="append", default=[])
    ap.add_argument("--recipe", action="store_true",
                    help="also train by the recipe (the default when no "
                         "--net or --order-seed is given)")
    ap.add_argument("--order-seed", type=int, action="append", default=[])
    ap.add_argument("--n-train", type=int, default=10_000)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    torch.set_num_threads(4)
    rng = np.random.default_rng(args.seed)
    x_train, y_train = port_syn.make_shapes(args.n_train, rng)
    x_test, y_test = port_syn.make_shapes(args.n_test, rng)
    data = (x_train, x_test, y_test)
    quiet = dict(epochs=args.epochs, log=lambda *a: None)

    for path in args.net:
        net = models.torch_twin("lenet")
        net.load_state_dict(torch.load(path, map_location="cpu"))
        report(path, net.eval(), data)
    if args.recipe or not (args.net or args.order_seed):
        net = port_syn.train_torch_lenet(x_train, y_train, **quiet)
        ref = jax_syn.train_torch_lenet(x_train, y_train, **quiet)
        same = all(torch.equal(a, b) for a, b in zip(
            net.state_dict().values(), ref.state_dict().values()))
        report(f"recipe (equal to the JAX helper's net: {same})", net, data)
    for order_seed in args.order_seed:
        net = port_syn.train_torch(
            models.torch_twin("lenet"), x_train, y_train,
            generator=torch.Generator().manual_seed(order_seed), **quiet)
        report(f"order seed {order_seed}", net, data)


if __name__ == "__main__":
    main()
