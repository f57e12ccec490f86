"""Operations and bytes from shapes, the benchmark's own count: the
multiply-adds of convolutions, dense layers and attention products, and
K1's bytes.  Forward hooks on the served UNet's modules record the shapes
of each call in the traced stretch; the configuration's ``count`` table
names which module classes are convolutions, denses and attentions."""

from __future__ import annotations

from typing import Dict, List


def conv_macs(n, ho, wo, cout, kh, kw, cin) -> int:
    return n * ho * wo * cout * kh * kw * cin


def dense_macs(rows, k, n) -> int:
    return rows * k * n


def attention_macs(batch, heads, sq, skv, d) -> int:
    """q·kᵀ and the weighted sum of v: two products of batch·heads·sq·skv·d."""
    return 2 * batch * heads * sq * skv * d


def k1_bytes(c: dict) -> int:
    """K1 reads the input's int8 codes, the weight's int8 codes, three
    float32 vectors a channel (code sums, scale, bias) and, where the conv
    pads, the int32 border map (Ho, Wo, Cout); it writes the output in the
    carrier's type.  Each byte once."""
    return (c["n"] * c["h"] * c["w"] * c["cin"] + c["cout"] * c["kh"] * c["kw"] * c["cin"]
            + 3 * 4 * c["cout"] + (4 * c["ho"] * c["wo"] * c["cout"] if c["padded"] else 0)
            + c["n"] * c["ho"] * c["wo"] * c["cout"] * c["out_bytes"])


def macs(c: dict) -> int:
    if c["kind"] == "conv":
        return conv_macs(c["n"], c["ho"], c["wo"], c["cout"], c["kh"], c["kw"], c["cin"])
    if c["kind"] == "dense":
        return dense_macs(c["rows"], c["k"], c["n_out"])
    return attention_macs(c["batch"], c["heads"], c["sq"], c["skv"], c["d"])


def _conv(m, args, out) -> dict:
    x = args[0]
    cout, cin, kh, kw = m.weight.shape
    padded = m.padding != "VALID" and m.padding != ((0, 0), (0, 0))
    return dict(kind="conv", n=x.shape[0], h=x.shape[1], w=x.shape[2], cin=cin,
                ho=out.shape[1], wo=out.shape[2], cout=cout, kh=kh, kw=kw, padded=padded,
                out_bytes=out.element_size(),
                k1=(getattr(m, "w0_int", None) is not None and not m.disable_act_quant
                    and not m.split))


def _dense(m, args, out) -> dict:
    x = args[0]
    return dict(kind="dense", rows=x.numel() // x.shape[-1], k=x.shape[-1], n_out=out.shape[-1])


def _pixel_attention(m, args, out) -> dict:
    n, h, w, c = args[0].shape
    return dict(kind="attention", batch=n, heads=1, sq=h * w, skv=h * w, d=c)


def _head_attention(m, args, out) -> dict:
    x, ctx = args[0], args[1] if len(args) > 1 else None
    skv = x.shape[1] if ctx is None else ctx.shape[1]
    return dict(kind="attention", batch=x.shape[0], heads=m.heads, sq=x.shape[1], skv=skv,
                d=m.dim_head)


KINDS = {"conv": _conv, "dense": _dense, "pixel_attention": _pixel_attention,
         "head_attention": _head_attention}


class ShapeLog:
    """Forward hooks that log each counted call while ``on``."""

    def __init__(self, model, table: Dict[str, str]):
        self.on, self.calls, self.handles = False, [], []
        for m in model.modules():
            kind = table.get(type(m).__name__)
            if kind is not None:
                fn = KINDS[kind]
                self.handles.append(m.register_forward_hook(
                    lambda mod, args, out, fn=fn: self.calls.append(fn(mod, args, out))
                    if self.on else None))

    def remove(self):
        for h in self.handles:
            h.remove()


def k1_calls(calls: List[dict]) -> List[dict]:
    return [c for c in calls if c["kind"] == "conv" and c["k1"]]
