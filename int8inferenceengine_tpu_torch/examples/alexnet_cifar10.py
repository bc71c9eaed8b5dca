"""AlexNet CIFAR10-224 — the reference's headline workflow as a script.

Mirrors sample/notebooks/AlexNet_cifar10_resize224.ipynb (reference): build
the torch Net and the engine MyNet side by side, load the torch weights,
time torch-FP32 / engine-FP32 / calibrate / engine-INT8 over the test set,
and count argmax agreement; then the INT8 model fed host-quantized u8
batches with the first conv laid out in advance (``DataLoader(quantize_to=,
layout_for=)``), and the per-layer quantization report.

Two data modes:

* default (no ``--data``): no CIFAR10 ships with the repository, so "test
  set" is a fixed random dataset and "labels" are the torch model's own
  argmax — measuring engine-vs-oracle agreement, the same comparison the
  notebook's accuracy delta captures.
* ``--data DIR``: a real ``cifar-10-batches-py`` directory (or an .npz
  with ``images`` [N,3,32,32] u8/f32 + ``labels``) — images are resized
  to 224 and ImageNet-normalized exactly like the reference notebook.
  Add ``--weights alex_cifar10_224.pt`` (a trained torch state_dict, the
  reference's own checkpoint format) and the printed numbers become TRUE
  labelled accuracy (the reference's README: 77.8% FP32, 76.1% INT8).

Run:  python -m int8inferenceengine_tpu_torch.examples.alexnet_cifar10
      [--images 2000] [--batch 100] [--model alexnet] [--device cpu]
      [--data cifar-10-batches-py/ [--weights alex_cifar10_224.pt]]
"""

import argparse
import os
import pickle
import sys
import time

import numpy as np
import torch

import int8inferenceengine_tpu_torch as q
from int8inferenceengine_tpu_torch import models
from int8inferenceengine_tpu_torch.data import DataLoader
from int8inferenceengine_tpu_torch.examples import add_device_arg, device_of
from int8inferenceengine_tpu_torch.utils import log_quantization_report

# the reference notebook's transforms: Resize(224) + ImageNet normalize
# (AlexNet_cifar10_resize224.ipynb cell 1)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_cifar10(data_dir: str, n: int, size: int = 224):
    """Real CIFAR-10 test images -> ([n,3,size,size] f32, [n] labels).

    Accepts the standard ``cifar-10-batches-py`` directory (test_batch
    pickle) or any ``.npz`` with ``images``/``labels``.  Bilinear resize
    via torch on the CPU (no torchvision dependency), then ImageNet
    normalization — the reference notebook's exact input pipeline.
    """
    import torch.nn.functional as tF

    npz = [f for f in os.listdir(data_dir)] if os.path.isdir(data_dir) \
        else []
    if os.path.isfile(data_dir) and data_dir.endswith(".npz"):
        d = np.load(data_dir)
        images, labels = d["images"], d["labels"]
    elif "test_batch" in npz:
        with open(os.path.join(data_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images = d[b"data"].reshape(-1, 3, 32, 32)
        labels = np.asarray(d[b"labels"])
    else:
        raise FileNotFoundError(
            f"{data_dir}: expected a cifar-10-batches-py dir (with "
            f"test_batch) or an .npz with images/labels")
    images, labels = images[:n], labels[:n].astype(np.int64)
    x = images.astype(np.float32)
    if x.max() > 1.5:          # u8 [0,255] -> [0,1]
        x = x / 255.0
    x = tF.interpolate(torch.tensor(x), size=(size, size), mode="bilinear",
                       align_corners=False).numpy()
    x = (x - _IMAGENET_MEAN.reshape(1, 3, 1, 1)) \
        / _IMAGENET_STD.reshape(1, 3, 1, 1)
    return x.astype(np.float32), labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--model", default="alexnet",
                    help="any zoo model: fc_mnist simple_conv lenet alexnet "
                         "vgg11 resnet18 resnet34 resnet50 mobilenet_v1 "
                         "squeezenet googlenet")
    ap.add_argument("--data", default=None,
                    help="real CIFAR-10: cifar-10-batches-py dir or .npz")
    ap.add_argument("--weights", default=None,
                    help="trained torch state_dict (.pt); with --data the "
                         "numbers become TRUE labelled accuracy")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    t_start = time.perf_counter()
    checks = {"model": args.model, "batch": args.batch}

    print("== build twin models, load torch weights ==")
    tnet = models.torch_twin(args.model)
    if args.weights:
        tnet.load_state_dict(torch.load(args.weights, map_location="cpu"))
    tnet = tnet.eval().to(dev)
    net = models.build(args.model, device=dev)
    net.load(tnet.state_dict())

    true_labels = None
    if args.data:
        size = net.INPUT_SHAPE[-1]
        images, true_labels = load_cifar10(args.data, args.images, size)
        args.images = len(images)
        print(f"   real CIFAR-10: {args.images} images resized to {size}")
    else:
        rng = np.random.default_rng(0)
        shape = (args.images,) + net.INPUT_SHAPE
        images = rng.uniform(-1, 1, shape).astype(np.float32)
    checks["images"] = args.images

    print("== torch FP32 oracle ==")
    t0 = time.perf_counter()
    preds = []
    with torch.no_grad():
        for i in range(0, args.images, args.batch):
            preds.append(tnet(torch.tensor(images[i:i + args.batch],
                                           device=dev)).cpu().numpy()
                         .argmax(1))
    preds = np.concatenate(preds)
    dt = time.perf_counter() - t0
    print(f"   torch: {dt:.2f}s")
    checks["torch_fp32"] = {"seconds": dt, "img_per_s": args.images / dt}
    if true_labels is not None and args.weights:
        checks["torch_fp32"]["accuracy"] = float((preds == true_labels)
                                                 .mean())
        print(f"   torch TRUE accuracy: "
              f"{(preds == true_labels).mean():.1%} "
              f"(reference FP32: 77.8%, README.md:31)")
        labels = true_labels
        metric = "accuracy"
    else:
        labels = preds
        metric = "agreement"
    checks["metric"] = metric

    def run_engine(tag, loader):
        t0 = time.perf_counter()
        correct = 0
        codes = []
        for batch, lab in loader:
            out = net(batch)
            codes.append(out.data.clone())
            correct += int((q.argmax(out, 1)
                            == q.tensor(np.float32(lab), device=dev)).sum())
        dt = time.perf_counter() - t0
        print(f"   {tag}: {dt:.2f}s  ({args.images/dt:.0f} img/s)  "
              f"{metric} {correct}/{args.images} = "
              f"{correct/args.images:.1%}")
        checks[tag] = {"seconds": dt, "img_per_s": args.images / dt,
                       metric: correct / args.images}
        return torch.cat(codes)

    print("== engine FP32 ==")
    run_engine("engine FP32", DataLoader(images, args.batch, labels=labels,
                                         device=dev))

    print("== calibrate (1 batch) + convert ==")
    t0 = time.perf_counter()
    net.prepare()
    net(q.tensor(images[:args.batch], device=dev))
    net.convert()
    checks["calibration_s"] = time.perf_counter() - t0
    print(f"   calibration: {checks['calibration_s']:.2f}s")

    print("== engine INT8 ==")
    codes = run_engine("engine INT8", DataLoader(
        images, args.batch, labels=labels, device=dev))

    print("== engine INT8, host-quantized u8 ingest + first-conv pre-layout ==")
    codes_u8 = run_engine("engine INT8 (u8 ingest)", DataLoader(
        images, args.batch, labels=labels,
        quantize_to=(net.config.input_scale, net.config.input_zero_point),
        layout_for=net, device=dev))
    checks["u8_ingest_codes_equal"] = bool(torch.equal(codes, codes_u8))

    print("== per-layer quantization report ==")
    log_quantization_report(net, stream=sys.stdout)
    checks["wall_s"] = time.perf_counter() - t_start
    return checks


if __name__ == "__main__":
    main()
