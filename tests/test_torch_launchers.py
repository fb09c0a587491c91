"""The port's launchers (``rmm_tpu_torch/launchers/``): each script, run
with its defaults filled in and a stand-in ``python`` that records its
arguments, calls a CLI of the port with a command line that the CLI's
parser takes and that passes no flag the port refuses; and it is the JAX
package's launcher's command line with the module renamed, less the flags
the port's fused CLI refuses by name (``--scan_layers``, ``--dp``)."""
import os
import subprocess

import pytest

from rmm_tpu_torch.cli import benchmark, fttransformer, fused
from rmm_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "rmm_tpu_torch", "launchers")
JAX = os.path.join(ROOT, "launchers")
LAUNCHERS = ["benchmark/benchmark.sh", "fused/fused.sh",
             "link_prediction/link_prediction.sh",
             "mask_analysis/mask_analysis.sh",
             "self_supervised/self_supervised.sh",
             "supervised/supervised.sh", "tabgnn/tabgnn.sh"]
#: what each CLI module parses its flags with, and builds its config with
#: (which raises on a flag the port refuses)
CLIS = {
    "rmm_tpu_torch.cli.main": (config.create_parser,
                               config.config_from_args),
    "rmm_tpu_torch.cli.benchmark": (benchmark.build_parser,
                                    config.config_from_args),
    "rmm_tpu_torch.cli.fused": (fused.build_parser, fused.config_from_args),
    "rmm_tpu_torch.cli.fttransformer": (fttransformer.build_parser,
                                        fttransformer.config_from_args),
}
#: the JAX launchers' flags the port leaves out (the fused CLI refuses
#: them by name)
DROPPED = {"--scan_layers"}


def calls(script: str, tmp_path, extra=(), **variables) -> list[list[str]]:
    """The argument lists of each ``python`` call the launcher makes, with
    DATA and TRACE_DIR set, ``variables`` too and every other variable at
    its default."""
    bin_dir = tmp_path / "bin"
    rec = tmp_path / "calls"
    bin_dir.mkdir(exist_ok=True)
    rec.mkdir(exist_ok=True)
    for f in rec.iterdir():
        f.unlink()
    fake = bin_dir / "python"
    fake.write_text('#!/bin/sh\nn=$(ls "$CALLS" | wc -l)\n'
                    'for a in "$@"; do printf "%s\\0" "$a"; done '
                    '> "$CALLS/$n"\n')
    fake.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MODEL", "EPOCHS", "MODE", "DP", "NEGS", "ITERS")}
    env.update(PATH=f"{bin_dir}:{env['PATH']}", CALLS=str(rec),
               DATA="/data/aml.csv", TRACE_DIR="/traces", **variables)
    subprocess.run(["bash", script, *extra], env=env, check=True,
                   capture_output=True, timeout=60)
    return [(rec / str(i)).read_bytes().decode().split("\0")[:-1]
            for i in range(len(list(rec.iterdir())))]


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_command_parses_and_is_ported(name, tmp_path):
    got = calls(os.path.join(PORT, name), tmp_path)
    assert got
    for argv in got:
        assert argv[0] == "-m" and argv[1] in CLIS, argv
        parser, build = CLIS[argv[1]]
        args = parser().parse_args(argv[2:])
        cfg = build(args)      # raises NotImplementedError on a refused flag
        assert args.device == cfg.device == "cuda"
    # extra arguments pass through: --device cpu runs on the CPU
    for argv in calls(os.path.join(PORT, name), tmp_path, ["--device",
                                                           "cpu"]):
        parser, build = CLIS[argv[1]]
        assert build(parser().parse_args(argv[2:])).device == "cpu"


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_mirrors_the_jax_launcher(name, tmp_path):
    ours = calls(os.path.join(PORT, name), tmp_path)
    theirs = calls(os.path.join(JAX, name), tmp_path)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        b = [x.replace("rmm_tpu.cli.", "rmm_tpu_torch.cli.") for x in b
             if x not in DROPPED]
        assert a == b


def test_fused_launcher_leaves_out_what_the_port_refuses(tmp_path):
    """DP=N adds ``--dp N`` to the JAX launcher; the port's launcher
    leaves it out (and ``--scan_layers``), as its fused CLI refuses both
    by name."""
    (theirs,) = calls(os.path.join(JAX, "fused/fused.sh"), tmp_path, DP="8")
    assert "--dp" in theirs and "--scan_layers" in theirs
    (argv,) = calls(os.path.join(PORT, "fused/fused.sh"), tmp_path, DP="8")
    assert "--dp" not in argv and "--scan_layers" not in argv
    for flag in (["--dp", "8"], ["--scan_layers"]):
        args = fused.build_parser().parse_args(argv[2:] + flag)
        with pytest.raises(NotImplementedError, match=flag[0]):
            fused.config_from_args(args)
