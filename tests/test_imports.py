"""The engines import without the optional packages the GPU machine may
lack (orbax, cv2, PIL)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engines_leave_orbax_cv2_pil_unimported():
    code = ("import sys, lstm_unet_tpu.engine.infer, "
            "lstm_unet_tpu.engine.train, lstm_unet_tpu.cli.train2d, "
            "lstm_unet_tpu.cli.inference2d; "
            "print(sorted({k.split('.')[0] for k in sys.modules} "
            "& {'orbax', 'cv2', 'PIL'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
