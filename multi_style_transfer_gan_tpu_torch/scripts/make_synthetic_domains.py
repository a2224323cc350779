"""Generate the synthetic unpaired photo/monet dataset on the host (the flags
of the JAX repo's ``scripts/make_synthetic_domains.py``).

  python -m multi_style_transfer_gan_tpu_torch.scripts.make_synthetic_domains \\
      --root data/synth_monet2photo [--n_train 400] [--n_test 54] \\
      [--size 256] [--seed 0]

See ``data/synthetic.py`` for the domain design (disjoint seed ranges, so
the training sets are unpaired; the test split ships ground truth).
"""

import argparse
import json
import time

from ..data.synthetic import write_domains


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--n_train", type=int, default=400)
    p.add_argument("--n_test", type=int, default=54)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    t0 = time.time()
    manifest = write_domains(args.root, n_train=args.n_train,
                             n_test=args.n_test, size=args.size,
                             seed=args.seed)
    print(json.dumps({"root": args.root, "seconds": round(time.time() - t0, 1),
                      **manifest}))


if __name__ == "__main__":
    main()
