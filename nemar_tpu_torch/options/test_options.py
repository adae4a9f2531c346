"""Test options (reference options/test_options.py), this package's copy
of ``nemar_tpu/options/test_options.py``."""

from nemar_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    def __init__(self):
        super().__init__()
        self.isTrain = False

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument("--results_dir", type=str, default="./results/",
                            help="saves results here")
        parser.add_argument("--aspect_ratio", type=float, default=1.0,
                            help="aspect ratio of result images")
        parser.add_argument("--phase", type=str, default="test", help="train, val, test")
        parser.add_argument("--eval", action="store_true",
                            help="use eval mode during test time")
        parser.add_argument("--num_test", type=int, default=50,
                            help="how many test images to run")
        parser.add_argument("--ntest", type=int, default=float("inf"), help="# of test examples")
        parser.add_argument("--eval_registration", action="store_true",
                            help="compute registration metrics (NCC/PSNR/L1 of the "
                                 "registered translation vs B; flow EPE in px when "
                                 "the dataset provides ground truth) -> eval.json")
        # Reference forces these at test time (SURVEY §4.3).
        parser.set_defaults(load_size=parser.get_default("crop_size"))
        return parser

    def parse(self, args=None):
        opt = super().parse(args)
        # batch_size 1, ordered, no flip — reference test.py invariants.
        opt.batch_size = 1
        opt.serial_batches = True
        opt.no_flip = True
        return opt
