"""Train options (reference options/train_options.py), this package's copy
of ``nemar_tpu/options/train_options.py``. The flags whose code paths are
not ported or are TPU-only are parsed and refused by the model, by name
(``--steps_per_execution > 1``, ``--opt_fused``, ``--opt_split``)."""

from nemar_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    def __init__(self):
        super().__init__()
        self.isTrain = True

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        # -- display / logging --
        parser.add_argument("--display_freq", type=int, default=400,
                            help="frequency of saving visual image grids")
        # visdom-era flags, accepted for reference-CLI compatibility;
        # visuals go to PNG grids + the HTML site instead of a live server.
        parser.add_argument("--display_id", type=int, default=1,
                            help="accepted for compatibility (no visdom here)")
        parser.add_argument("--display_server", type=str, default="http://localhost",
                            help="accepted for compatibility (no visdom here)")
        parser.add_argument("--display_port", type=int, default=8097,
                            help="accepted for compatibility (no visdom here)")
        parser.add_argument("--display_env", type=str, default="main",
                            help="accepted for compatibility (no visdom here)")
        parser.add_argument("--display_ncols", type=int, default=4,
                            help="accepted for compatibility (no visdom here)")
        parser.add_argument("--update_html_freq", type=int, default=1000,
                            help="frequency of saving training results to html")
        parser.add_argument("--print_freq", type=int, default=100,
                            help="frequency of printing losses on console")
        parser.add_argument("--save_latest_freq", type=int, default=5000,
                            help="frequency of saving the latest checkpoint (iters)")
        parser.add_argument("--save_epoch_freq", type=int, default=5,
                            help="frequency of saving checkpoints (epochs)")
        parser.add_argument("--save_by_iter", action="store_true",
                            help="save by iteration count")
        parser.add_argument("--no_html", action="store_true",
                            help="do not save intermediate results to web/")
        # -- resume --
        parser.add_argument("--continue_train", action="store_true",
                            help="continue training: load the latest model")
        parser.add_argument("--auto_resume", action="store_true",
                            help="resume from the latest checkpoint automatically "
                                 "when one exists (preemption-safe restarts)")
        parser.add_argument("--epoch_count", type=int, default=1,
                            help="the starting epoch count")
        parser.add_argument("--phase", type=str, default="train", help="train, val, test")
        # -- training schedule --
        # Modern template naming; --niter/--niter_decay accepted as aliases
        # for the older vintage (SURVEY.md §8.4(f)).
        parser.add_argument("--n_epochs", "--niter", dest="n_epochs", type=int, default=100,
                            help="number of epochs at the initial learning rate")
        parser.add_argument("--n_epochs_decay", "--niter_decay", dest="n_epochs_decay",
                            type=int, default=100,
                            help="number of epochs to linearly decay lr to zero")
        parser.add_argument("--beta1", type=float, default=0.5, help="momentum term of adam")
        parser.add_argument("--opt_fused", action="store_true",
                            help="single-flat-vector Adam update (identical "
                                 "math, one kernel instead of ~100 per-leaf "
                                 "launches — models/optim.py). Optimizer-"
                                 "state checkpoints are shape-incompatible "
                                 "across this flag")
        parser.add_argument("--opt_split", action="store_true",
                            help="compile the G/R Adam update as its OWN "
                                 "jitted program (two dispatches per step) "
                                 "with the flat-bucket math of --opt_fused. "
                                 "Works around the compile-helper OOM that "
                                 "kills --opt_fused inside the pallas-trunk "
                                 "step program (probes r3q/r4d). Implies the "
                                 "--opt_fused checkpoint layout; incompatible "
                                 "with --steps_per_execution > 1 and "
                                 "--grad_accum > 1")
        parser.add_argument("--lr", type=float, default=0.0002, help="initial adam learning rate")
        parser.add_argument("--gan_mode", type=str, default="lsgan",
                            help="GAN objective [vanilla | lsgan | wgangp]")
        parser.add_argument("--pool_size", type=int, default=50,
                            help="size of the image buffer that stores previously generated images")
        parser.add_argument("--lr_policy", type=str, default="linear",
                            help="learning rate policy [linear | step | plateau | cosine]")
        parser.add_argument("--lr_decay_iters", type=int, default=50,
                            help="multiply lr by 0.1 every lr_decay_iters (step policy)")
        # -- TPU-native extras --
        parser.add_argument("--steps_per_execution", type=int, default=1,
                            help="train steps fused into one device dispatch (lax.scan)")
        parser.add_argument("--async_checkpoint", action="store_true",
                            help="write checkpoints asynchronously (orbax)")
        parser.add_argument("--transfer_guard", type=str, default="allow",
                            help="jax transfer guard around the hot loop "
                                 "[allow | log | disallow] — catches implicit "
                                 "host<->device syncs (SURVEY §6 sanitizers)")
        return parser
