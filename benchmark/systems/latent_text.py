"""A text-conditioned latent UNet served by ``LDMPipeline.sample_batch``:
the mix's sampler (the program's by that name, the reference's replay
from ``reference/samplers.py``'s table), classifier-free guidance where
the mix's ``guidance`` is not 1, a step's noise handed in from the seed
where its ``eta`` is above 0, and the first-stage decode; the prompts
encoded by ``LatentDiffusion.get_learned_conditioning`` once a batch, in
the window."""

from __future__ import annotations

import torch

from benchmark.lib import systems, weights
from benchmark.lib.standin import set_state, tf32
from benchmark.reference import ldm, samplers, text, vae
from benchmark.reference.quant import Ctx, calibrate


class System(systems.System):
    def sample_shape(self):
        u = self.config["unet"]
        return (u["image_size"], u["image_size"], u["in_channels"])

    @property
    def guidance(self):
        """The guidance scale, or None where the mix serves unguided."""
        g = float(self.spec.get("guidance", 1.0))
        return None if g == 1.0 else g

    def steps(self):
        d = self.config["diffusion"]
        return samplers.ldm_steps(d["timesteps"], d["linear_start"], d["linear_end"],
                                  self.spec["steps"], self.device)

    def setup(self):
        cfg, spec = self.config, self.spec
        self.build_kernels()
        self.mark("kernels")
        p = cfg["program"]
        mc = systems.resolve(p["model"])(
            unet=systems.resolve(p["unet"])(**systems.tuples(cfg["unet"])),
            vae=systems.resolve(p["vae"])(**systems.tuples(cfg["vae"])),
            **cfg["diffusion"], cond="text")
        tc = systems.resolve(p["task_config"])(
            p["task"], custom_steps=spec["steps"], eta=self.eta,
            scale=spec.get("guidance", 1.0), sampler=spec["sampler"],
            batch_size=self.traffic.batch, seed=self.program_seed,
            **{k: cfg["quant"][k] for k in ("weight_bit", "act_bit", "sm_abit")})
        self.pipe = pipe = systems.resolve(p["pipeline"])(tc, model_cfg=mc, device=self.device,
                                                          seed=self.program_seed)
        self.mark("pipeline")
        te = cfg["text_encoder"]
        enc = pipe.ld.cond_stage
        got = dict(width=enc.pos.shape[-1], max_length=enc.max_length, vocab=enc.vocab,
                   depth=enc.depth, heads=enc.heads)
        if any(got[k] != te[k] for k in got):
            raise RuntimeError(f"the program's text encoder is {got}, the configuration's {te}")
        for module, cls, arch, tag in ((pipe.ld.unet, ldm.LDMUNet, cfg["unet"], "unet"),
                                       (pipe.ld.first_stage, vae.FirstStage, cfg["vae"], "vae"),
                                       (enc, text.TextEncoder, te, "text")):
            weights.load(module, self.state(cls, arch, tag), f"program {tag}")
        self.mark("weights")
        x, t, c = self.calibration_inputs()
        set_state(pipe.ld.unet, (x, t), {"context": c})
        self.mark("quant_state")
        self.unet, self.mode = pipe.serving_variables(serve=self.serve)
        pipe.ld.unet = self.unet                     # the float model is dropped
        self.mark("export")
        self.rows = self.traffic.batch * (1 if self.guidance is None else 2)  # [uncond; cond]
        self.forwards_per_batch = len(self.sampler.forwards(self.steps()))
        self.out_shape = (self.rows,) + self.sample_shape()[:2] + (cfg["unet"]["out_channels"],)

    def calibration_inputs(self, encode=None):
        """The stand-in quant state's rows: the configuration's calibration
        prompts and the empty prompt, under guidance's doubled batch."""
        n = int(self.config["calibration"]["prompts"])
        encode = encode or self.pipe.ld.get_learned_conditioning
        x = self.traffic.x_T("calib", n)
        t = self.traffic.timesteps("calib", n, self.config["diffusion"]["timesteps"])
        c = torch.cat([encode([""] * n), encode(self.traffic.prompts("calib", n))])
        return torch.cat([x, x]), torch.cat([t, t]), c

    def conditioning(self, b):
        """Batch ``b``'s prompts encoded, and the empty prompt's rows where
        the mix is guided."""
        enc = self.pipe.ld.get_learned_conditioning
        unc = None if self.guidance is None else enc([""] * self.traffic.batch)
        return enc(self.traffic.prompts(b)), unc

    def wrap_decode(self, before, after):
        """Call ``before(z)`` and ``after(images)`` around the program's
        first-stage decode (in place of an earlier window's calls)."""
        ld = self.pipe.ld
        orig = self.__dict__.setdefault("_decode", ld.decode_first_stage)

        def decode(z, *args, **kwargs):
            before(z)
            out = orig(z, *args, **kwargs)
            after(out)
            return out
        ld.decode_first_stage = decode

    def warm_up(self):
        ctx, unc = self.conditioning("warm")
        x = self.traffic.x_T("warm")
        ct = next(self.unet.parameters()).dtype
        if unc is not None:
            x, ctx = torch.cat([x, x]), torch.cat([unc, ctx])
        t = torch.full((self.rows,), 500.0, device=self.device)
        self.unet(x.to(ct), t, context=ctx.to(ct), mode=self.mode)
        with tf32():
            self.pipe.ld.decode_first_stage(x[:self.traffic.batch])

    def run_batch(self, b):
        ctx, unc = self.conditioning(b)
        return self.pipe.sample_batch(self.mode, x_T=self.traffic.x_T(b), noise=self.noise(b),
                                      context=ctx, uncond=unc, unet=self.unet)

    def release(self):
        del self.unet, self.pipe

    @torch.no_grad()
    def check(self, batches, control=False):
        """``eps_err`` and ``sample_err`` as the pixel system's (the replay
        from x_T through the sampler and guidance to the latents the decode
        took), and ``decode_err``: the images against the reference's
        decode of the program's latents, worst image.  The reference
        conditions on its own encoding of each batch's prompts.  With
        ``control``: fp8 carrier, a bfloat16 replay, a TF32 decode."""
        cfg = self.config
        d = cfg["diffusion"]
        with tf32():
            enc = self.reference(text.TextEncoder, cfg["text_encoder"], "text")
            ref = self.reference(ldm.LDMUNet, cfg["unet"], "unet")
            first = self.reference(vae.FirstStage, cfg["vae"], "vae")
            x_cal, t_cal, c_cal = self.calibration_inputs(enc.encode)
            calibrate(ref, lambda ctx: ldm.forward_blocks(ref, x_cal, t_cal, c_cal, ctx,
                                                          self.ref_rows))
            steps = self.steps()
            order = self.sampler.forwards(steps)
            gaps = systems.Gaps()
            for rec in batches:
                c = enc.encode(self.traffic.prompts(rec.index))
                if self.guidance is not None:
                    c = torch.cat([enc.encode([""] * self.traffic.batch), c])
                for f, x in rec.inputs.items():
                    t = torch.full((x.shape[0],), float(order[f]), device=self.device)
                    e_ref = ldm.forward_blocks(ref, x, t, c, Ctx(), self.ref_rows)
                    e = (ldm.forward_blocks(ref, x, t, c, Ctx(carrier=torch.float8_e4m3fn),
                                            self.ref_rows) if control
                         else rec.eps[f].to(self.device))
                    gaps.add("eps_err", e, e_ref, batch=rec.index, forward=f)
                z_ref = self.replay(rec, steps, torch.float32, self.guidance)
                z = self.replay(rec, steps, torch.bfloat16, self.guidance) if control else rec.latents
                gaps.add("sample_err", z, z_ref, batch=rec.index)
                decode = lambda: torch.cat([
                    torch.clamp((first.decode(zb) + 1.0) / 2.0, 0.0, 1.0) for zb in
                    (rec.latents / d["scale_factor"]).split(max(1, self.ref_rows // 2))])
                img_ref = decode()
                if control:
                    with tf32(True):
                        img = decode()
                else:
                    img = rec.images
                gaps.add("decode_err", img, img_ref, batch=rec.index)
        self.detail = gaps.detail
        return gaps.numbers()
