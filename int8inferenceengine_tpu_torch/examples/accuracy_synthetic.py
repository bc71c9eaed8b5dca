"""True accuracy-delta measurement on a learnable synthetic task.

No image dataset ships with the repository, so the accuracy tables measure
FP32-vs-INT8 *agreement*.  This example closes the loop the way the
reference's README does (FP32 77.8% vs engine-INT8 76.1%, a 1.7-point
drop): it trains a real classifier (the LeNet torch twin, or ``--model
deep8``) on a procedurally generated shape-classification task on the
chosen device, then runs the full PTQ lifecycle and reports *labelled test
accuracy* for torch-FP32, engine-FP32 and seven engine-INT8 legs (trunc,
cross-layer equalization, per-channel, nearest, bias correction, AdaRound,
all levers).

    python -m int8inferenceengine_tpu_torch.examples.accuracy_synthetic \
        [--n-train 10000] [--n-test 2000] [--model lenet|deep8] [--device cpu]
        [--save-net PATH]

The task: 28x28 images, 4 shape classes (horizontal bar, vertical bar,
cross, hollow box) at random positions/sizes over Gaussian noise — easy
enough to train in seconds, hard enough that accuracy is not saturated at
100% (noise + small shapes), so quantization deltas are visible.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import QuantConfig, models
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.utils import adaround, cross_layer_equalize


def make_shapes(n: int, rng: np.random.Generator, size: int = 28):
    """n noisy size x size images in 4 shape classes."""
    imgs = rng.normal(0.0, 0.35, size=(n, 1, size, size)).astype(np.float32)
    labels = rng.integers(0, 4, size=n)
    for i, cls in enumerate(labels):
        r = int(rng.integers(6, size - 8))
        c = int(rng.integers(6, size - 8))
        half = int(rng.integers(4, 8))
        lo_r, hi_r = max(0, r - half), min(size, r + half)
        lo_c, hi_c = max(0, c - half), min(size, c + half)
        amp = float(rng.uniform(0.8, 1.2))
        im = imgs[i, 0]
        if cls == 0:      # horizontal bar
            im[r - 1:r + 1, lo_c:hi_c] += amp
        elif cls == 1:    # vertical bar
            im[lo_r:hi_r, c - 1:c + 1] += amp
        elif cls == 2:    # cross
            im[r - 1:r + 1, lo_c:hi_c] += amp
            im[lo_r:hi_r, c - 1:c + 1] += amp
        else:             # hollow box
            im[lo_r:hi_r, lo_c:lo_c + 2] += amp
            im[lo_r:hi_r, hi_c - 2:hi_c] += amp
            im[lo_r:lo_r + 2, lo_c:hi_c] += amp
            im[hi_r - 2:hi_r, lo_c:hi_c] += amp
    return imgs, labels.astype(np.int64)


def build_deep8(config=None, device=None):
    """8-compute-layer convnet (6 conv + 2 fc) — AlexNet-depth, 32x32.

    The LeNet study guards the ≤1.7-pt budget at 4 quantized boundaries;
    requant noise compounds per layer, so this net pins it at headline
    depth (the reference's AlexNet is 5 conv + 3 fc = 8 compute layers)."""

    class Deep8(q.Module):
        def __init__(self, cfg=None, device=None):
            super().__init__(cfg or QuantConfig(), device)
            c, d = self.config, self.device
            self.conv1 = q.Conv2d(1, 32, 3, padding=1, config=c, device=d)
            self.conv2 = q.Conv2d(32, 32, 3, padding=1, config=c, device=d)
            self.conv3 = q.Conv2d(32, 64, 3, padding=1, config=c, device=d)
            self.conv4 = q.Conv2d(64, 64, 3, padding=1, config=c, device=d)
            self.conv5 = q.Conv2d(64, 128, 3, padding=1, config=c, device=d)
            self.conv6 = q.Conv2d(128, 128, 3, padding=1, config=c,
                                  device=d)
            self.fc1 = q.Linear(128 * 4 * 4, 256, config=c, device=d)
            self.fc2 = q.Linear(256, 4, config=c, device=d)

        def forward(self, x):
            x = q.relu(self.conv1(x))
            x = q.max_pool2d(q.relu(self.conv2(x)), 2, 2)
            x = q.relu(self.conv3(x))
            x = q.max_pool2d(q.relu(self.conv4(x)), 2, 2)
            x = q.relu(self.conv5(x))
            x = q.max_pool2d(q.relu(self.conv6(x)), 2, 2)
            x = x.reshape(-1, 128 * 4 * 4)
            return self.fc2(q.relu(self.fc1(x)))

    return Deep8(config, device)


def torch_deep8(seed: int = 0):
    """The torch twin of ``build_deep8`` on the CPU; ``torch.manual_seed``
    fixes its initial weights."""
    import torch.nn as nn

    torch.manual_seed(seed)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
            self.conv2 = nn.Conv2d(32, 32, 3, padding=1)
            self.conv3 = nn.Conv2d(32, 64, 3, padding=1)
            self.conv4 = nn.Conv2d(64, 64, 3, padding=1)
            self.conv5 = nn.Conv2d(64, 128, 3, padding=1)
            self.conv6 = nn.Conv2d(128, 128, 3, padding=1)
            self.fc1 = nn.Linear(128 * 4 * 4, 256)
            self.fc2 = nn.Linear(256, 4)

        def forward(self, x):
            x = torch.relu(self.conv1(x))
            x = torch.max_pool2d(torch.relu(self.conv2(x)), 2, 2)
            x = torch.relu(self.conv3(x))
            x = torch.max_pool2d(torch.relu(self.conv4(x)), 2, 2)
            x = torch.relu(self.conv5(x))
            x = torch.max_pool2d(torch.relu(self.conv6(x)), 2, 2)
            x = x.reshape(-1, 128 * 4 * 4)
            return self.fc2(torch.relu(self.fc1(x)))

    return Net()


def train_torch(net, x, y, epochs=2, batch=128, seed=0, log=print,
                device="cpu", generator=None):
    """Train any torch net on the shapes task (Adam) on ``device``.  Each
    epoch's batch order is drawn on the CPU from ``generator`` (default: a
    ``torch.Generator`` seeded with ``seed``, the stream that
    ``torch.manual_seed(seed)`` gives the global one), so the order does
    not depend on the device.  Returns the net, on ``device``, in eval
    mode."""
    import torch.nn as nn

    dev = torch.device(device)
    net = net.to(dev)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(seed)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    loss_fn = nn.CrossEntropyLoss()
    xt, yt = torch.tensor(x, device=dev), torch.tensor(y, device=dev)
    for ep in range(epochs):
        perm = torch.randperm(len(xt), generator=gen).to(dev)
        tot = 0.0
        for i in range(0, len(xt), batch):
            idx = perm[i:i + batch]
            opt.zero_grad()
            loss = loss_fn(net(xt[idx]), yt[idx])
            loss.backward()
            opt.step()
            tot += float(loss.detach()) * len(idx)
        log(f"  epoch {ep + 1}: train loss {tot / len(xt):.4f}")
    net.eval()
    return net


def train_torch_lenet(x, y, epochs=2, batch=128, seed=0, log=print,
                      device="cpu"):
    """The LeNet twin (``models.torch_twin("lenet")``, whose own seed fixes
    its weights) trained as ``train_torch`` trains, the batch order drawn
    from the global RNG's stream just after the twin's initialisation: the
    JAX package's recipe (``examples/accuracy_synthetic.py``), bit for bit
    on the CPU.  ``seed`` changes nothing, as there."""
    net = models.torch_twin("lenet")
    gen = torch.Generator()
    gen.set_state(torch.get_rng_state())
    return train_torch(net, x, y, epochs=epochs, batch=batch, seed=seed,
                       log=log, device=device, generator=gen)


INT8_LEGS = (
    # (tag, QuantConfig keywords, cross-layer equalization, AdaRound)
    ("engine_int8", {}, False, False),
    ("engine_int8_cle", {}, True, False),
    ("engine_int8_per_channel", dict(weight_per_channel=True), False, False),
    ("engine_int8_nearest", dict(rounding="nearest"), False, False),
    ("engine_int8_biascorr", dict(bias_correction=True), False, False),
    ("engine_int8_adaround", {}, False, True),
    ("engine_int8_all_levers",
     dict(weight_per_channel=True, rounding="nearest", bias_correction=True),
     True, False),
)


def accuracy_report(net, x_test, y_test, calib, build=None, tags=None,
                    device=None):
    """Returns dict of labelled accuracies across the quantization paths.

    ``build(config=..., device=...)`` constructs the engine twin of ``net``
    (default: the LeNet zoo model) on ``device`` (the torch net's own by
    default).  ``tags`` selects a subset of the INT8 configs (None =
    all)."""
    dev = torch.device(device) if device is not None else \
        next(net.parameters()).device
    if build is None:
        def build(config=None, device=None):
            return models.build("lenet", config=config or QuantConfig(),
                                device=device)

    with torch.no_grad():
        torch_acc = float((net(torch.tensor(x_test, device=dev)).argmax(1)
                           .cpu().numpy() == y_test).mean())
    accs = {"torch_fp32": torch_acc}
    state = net.state_dict()

    mm = build(device=dev)
    mm.load(state)
    accs["engine_fp32"] = float(
        (mm(q.tensor(x_test, device=dev)).numpy().argmax(1) == y_test)
        .mean())

    for tag, cfg, cle, ada in INT8_LEGS:
        if tags is not None and tag not in tags:
            continue
        mq = build(config=QuantConfig(**cfg), device=dev)
        mq.load(state)
        if cle:   # data-free cross-layer equalization before calibration
            convs = sorted(n for n, _ in mq.named_layers()
                           if n.startswith("conv"))
            pairs = [(convs[i], convs[i + 1])
                     for i in range(0, len(convs) - 1, 2)]
            cross_layer_equalize(mq, pairs + [("fc1", "fc2")])
        mq.prepare()
        mq(q.tensor(calib, device=dev))
        if ada:   # data-driven rounding optimization before convert
            adaround(mq, calib, iters=200)
        mq.convert()
        accs[tag] = float(
            (mq(q.tensor(x_test, device=dev)).numpy().argmax(1) == y_test)
            .mean())
    return accs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-train", type=int, default=10_000)
    ap.add_argument("--n-test", type=int, default=2_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=("lenet", "deep8"), default="lenet",
                    help="lenet: 4 compute layers @28x28; deep8: 6 conv + "
                         "2 fc @32x32 (AlexNet depth — requant noise "
                         "compounds per layer)")
    ap.add_argument("--save-net", default=None, metavar="PATH",
                    help="write the trained twin's state dict here "
                         "(torch.save, CPU tensors)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()

    rng = np.random.default_rng(args.seed)
    size = 32 if args.model == "deep8" else 28
    x_train, y_train = make_shapes(args.n_train, rng, size=size)
    x_test, y_test = make_shapes(args.n_test, rng, size=size)
    calib = x_train[:100]

    t0 = time.time()
    if args.model == "deep8":
        net = train_torch(torch_deep8(args.seed), x_train, y_train,
                          epochs=args.epochs, seed=args.seed, device=dev)
        build = build_deep8
    else:
        net = train_torch_lenet(x_train, y_train, epochs=args.epochs,
                                seed=args.seed, device=dev)
        build = None
    train_s = time.time() - t0
    print(f"trained in {train_s:.1f}s")
    if args.save_net:
        torch.save({k: v.cpu() for k, v in net.state_dict().items()},
                   args.save_net)

    accs = accuracy_report(net, x_test, y_test, calib, build=build,
                           device=dev)
    print(f"\nLabelled test accuracy ({args.n_test} images, 4 classes):")
    for k, v in accs.items():
        delta = accs["torch_fp32"] - v
        print(f"  {k:24s} {v * 100:6.2f}%   (drop vs torch FP32: "
              f"{delta * 100:+.2f} pts; negative = better)")
    print("\nReference's headline delta for comparison: 1.7 pts "
          "(README.md:31-35).")
    return {"model": args.model, "n_train": args.n_train,
            "n_test": args.n_test, "epochs": args.epochs, "train_s": train_s,
            "accuracy": accs,
            "drop_pts": {k: 100 * (accs["torch_fp32"] - v)
                         for k, v in accs.items()},
            "wall_s": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
