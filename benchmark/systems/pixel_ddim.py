"""A pixel-space DDPM UNet served by ``CifarPipeline.sample_batch``
(DDIM over the mix's grid), x_T handed in from the seed.

The program's entry draws a step's noise from its own generator and takes
none from the caller, so the reference could not replay it: this system
serves DDIM at eta 0 only, and says so at set-up."""

from __future__ import annotations

import torch

from benchmark.lib import systems, weights
from benchmark.lib.standin import set_state, tf32
from benchmark.reference import ddpm, samplers
from benchmark.reference.quant import Ctx, calibrate


class System(systems.System):
    def sample_shape(self):
        u = self.config["unet"]
        return (u["resolution"], u["resolution"], u["in_channels"])

    def setup(self):
        cfg, spec = self.config, self.spec
        if spec["sampler"] != "ddim" or self.eta:
            raise ValueError("the pixel pipeline takes no noise from its caller: "
                             "this system serves DDIM at eta 0")
        self.build_kernels()
        self.mark("kernels")
        arch = systems.resolve(cfg["program"]["arch"])(**systems.tuples(cfg["unet"]))
        pc = systems.resolve(cfg["program"]["pipeline_config"])(
            timesteps=spec["steps"], skip_type=spec["skip"], eta=self.eta,
            sample_batch_size=self.traffic.batch, seed=self.program_seed, arch=arch,
            **cfg["schedule"], **{k: cfg["quant"][k] for k in ("weight_bit", "act_bit", "sm_abit")})
        self.pipe = systems.resolve(cfg["program"]["pipeline"])(pc, device=self.device)
        model = self.pipe.init_variables()
        self.mark("pipeline")
        weights.load(model, self.state(ddpm.DDPMUNet, cfg["unet"], "unet"), "program unet")
        self.mark("weights")
        set_state(model, self.calibration_inputs(), {})
        self.mark("quant_state")
        self.unet, self.mode = self.pipe.serving_variables(model, serve=self.serve)
        del model
        self.mark("export")
        self.forwards_per_batch = len(self.pipe.seq)
        self.rows = self.traffic.batch
        self.out_shape = (self.rows,) + self.sample_shape()[:2] + (cfg["unet"]["out_ch"],)

    def calibration_inputs(self):
        rows = int(self.config["calibration"]["rows"])
        t = self.traffic.timesteps("calib", rows, self.config["schedule"]["num_diffusion_timesteps"])
        return self.traffic.x_T("calib", rows), t

    def warm_up(self):
        from eda_dm_tpu_torch.samplers.ddim import generalized_steps
        x = self.traffic.x_T("warm")
        generalized_steps(x, self.pipe.seq[:2], self.pipe.sampler_fn(self.unet, self.mode),
                          self.pipe.betas, eta=self.eta, device=self.device)

    def run_batch(self, b):
        return self.pipe.sample_batch(self.unet, mode=self.mode, x_T=self.traffic.x_T(b))

    def release(self):
        del self.unet, self.pipe

    @torch.no_grad()
    def check(self, batches, control=False):
        """``eps_err``: the UNet's output at the checked forwards against the
        reference's on the same inputs (the reference's own timestep), worst
        row.  ``sample_err``: the images against the reference's replay of
        the sampler from x_T over the program's recorded UNet outputs, worst
        row.  With ``control``, the control's readings in the program's place
        (fp8 carrier, a bfloat16 replay) against the reference's."""
        cfg, spec = self.config, self.spec
        with tf32():
            ref = self.reference(ddpm.DDPMUNet, cfg["unet"], "unet")
            x_cal, t_cal = self.calibration_inputs()
            calibrate(ref, lambda ctx: ddpm.forward_blocks(ref, x_cal, t_cal, ctx, self.ref_rows))
            s = cfg["schedule"]
            n = s["num_diffusion_timesteps"]
            steps = samplers.pixel_steps(
                samplers.linear_betas(s["beta_start"], s["beta_end"], n),
                samplers.GRIDS[spec["skip"]](spec["steps"], n), self.device)
            order = self.sampler.forwards(steps)
            gaps = systems.Gaps()
            for rec in batches:
                for f, x in rec.inputs.items():
                    t = torch.full((x.shape[0],), float(order[f]), device=self.device)
                    e_ref = ddpm.forward_blocks(ref, x, t, Ctx(), self.ref_rows)
                    e = (ddpm.forward_blocks(ref, x, t, Ctx(carrier=torch.float8_e4m3fn),
                                             self.ref_rows) if control
                         else rec.eps[f].to(self.device))
                    gaps.add("eps_err", e, e_ref, batch=rec.index, forward=f)
                image = lambda dtype: torch.clamp((self.replay(rec, steps, dtype) + 1.0) / 2.0,
                                                  0.0, 1.0)
                img_ref = image(torch.float32)
                img = image(torch.bfloat16) if control else rec.images
                gaps.add("sample_err", img, img_ref, batch=rec.index)
        self.detail = gaps.detail
        return gaps.numbers()
