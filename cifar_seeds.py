"""chip_smoke.py's CIFAR ResNet-110 fits (phase 16) over several seeds.

For each seed, train_cifar10.py --synthetic 5120's fit call on gpu(0),
eager and captured, under torch's default TF32, for CF_EPOCHS epochs:
each fit held to phase 16's learning check (the last 4 steps'
cross-entropy below half the first 4's) and its validation check, its
cross-entropy at each epoch's end and its validation readings printed.
Exits with another code than 0 at the first fit that fails.

    python3 cifar_seeds.py --seeds 0,1,2
"""
import argparse
import gc
import sys
import tempfile


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", default="0,1,2",
                        help="comma-separated seeds (default 0,1,2)")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("cifar_seeds.py: no CUDA device")
    import chip_smoke as cs
    import mxtpu_torch as mt
    card = cs.card_line()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as root, cs.tf32_mode(True):
        args = cs.cifar_args(synthetic=cs.CF_RECORDS,
                             num_examples=cs.CF_RECORDS,
                             num_epochs=cs.CF_EPOCHS)
        args.data_train, args.data_val = cs.cifar_synthetic(mt, args, root)
        for seed in (int(s) for s in opts.seeds.split(",")):
            for path in ("eager", "captured"):
                network = cs.resnet_symbol(mt, cs.CF_LAYERS, "3,28,28", 10)
                mod, train, val = cs.cifar_run(mt, args, network, seed, path,
                                               card, True)
                train.close()
                val.close()
                del mod
                gc.collect()
                torch.cuda.empty_cache()
                print("seed %d, %s: passed" % (seed, path), flush=True)


if __name__ == "__main__":
    main()
