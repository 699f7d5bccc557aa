"""Physically based per-vertex shading (the deferred-PBR stage).

Reference: ``gaussian_renderer/svgss.py`` ``rendering_equation4``
(:537-593) and ``GGX_specular4`` (:595-630), as ``svgir_tpu.ops.shading``
transcribes them.  Shading runs per surfel vertex (4 per surfel) over S
precomputed incident directions, before rasterization; the rasterizer then
blends the 12-channel results bilinearly.  Constants: global light clamp
[0, 64], fresnel 0.04, k = (alpha + 2 r + 1) / 8, Schlick
2^((-5.55473 VoH - 6.98316) VoH), denominator clamp [1e-6, 4 pi].  Vertex
channels are channel-major: [c0v0..c0v3, c1v0..].

The training step reads only ``pbr`` and ``diffuse_light``: it takes
``shade_train``, the kernel pair of ``csrc/shading.cu`` on CUDA tensors and
its plain version (``shade_train_forward_plain`` /
``shade_train_backward_plain``, the kernels' arithmetic and hand-derived
backward in PyTorch) on CPU tensors.  ``rendering_equation4`` serves
evaluation and relighting, which read its other terms.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from svgir_tpu_torch.kernels import shading as KS
from svgir_tpu_torch.utils.transforms import normalize


def ggx_specular4(normal: torch.Tensor, pts2c: torch.Tensor,
                  pts2l: torch.Tensor, roughness: torch.Tensor,
                  fresnel: float = 0.04) -> torch.Tensor:
    """GGX specular per (sample, vertex).  normal [N, 4, 3]; pts2c [N, 3];
    pts2l [N, S, 3]; roughness [N, 4] -> [N, S, 4, 1]."""
    L = normalize(pts2l)[:, :, None, :]                  # [N, S, 1, 3]
    V = normalize(pts2c)[:, None, :]                     # [N, 1, 3]
    H = normalize((L + V[:, None]) / 2.0)                # [N, S, 1, 3]
    N = normalize(normal)                                # [N, 4, 3]

    NoV = (V * N).sum(-1, keepdim=True)                  # [N, 4, 1]
    N = N * torch.sign(NoV)

    NoL = torch.clamp((N[:, None] * L).sum(-1, keepdim=True), 1e-6, 1)
    NoV = torch.clamp((N * V).sum(-1, keepdim=True), 1e-6, 1)
    NoH = torch.clamp((N[:, None] * H).sum(-1, keepdim=True), 1e-6, 1)
    VoH = torch.clamp((V[:, None] * H).sum(-1, keepdim=True), 1e-6, 1)

    rough = roughness[:, None, :, None]                  # [N, 1, 4, 1]
    alpha = rough * rough
    alpha2 = alpha * alpha
    k = (alpha + 2 * rough + 1.0) / 8.0
    fmi = ((-5.55473) * VoH - 6.98316) * VoH
    frac0 = fresnel + (1 - fresnel) * torch.pow(2.0, fmi)
    frac = frac0 * alpha2
    nom0 = NoH * NoH * (alpha2 - 1) + 1
    nom1 = NoV[:, None] * (1 - k) + k
    nom2 = NoL * (1 - k) + k
    nom = torch.clamp(4 * math.pi * nom0 * nom0 * nom1 * nom2, 1e-6,
                      4 * math.pi)
    return frac / nom


def rendering_equation4(base_color: torch.Tensor, roughness: torch.Tensor,
                        normals: torch.Tensor, viewdirs: torch.Tensor,
                        radiance: torch.Tensor, env_direct_light,
                        visibility: torch.Tensor, incident_dirs: torch.Tensor,
                        incident_areas: torch.Tensor,
                        env_radiance: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, Dict]:
    """Per-vertex rendering equation (svgss.py:537-593).

    base_color [N, 12] channel-major; roughness [N, 4]; normals [N, 4, 3];
    viewdirs [N, 3] (points -> camera); radiance [N, S, 3] (baked local
    incident light); env_direct_light: fn(dirs [N, S, 3]) -> [N, S, 3];
    visibility [N, S, 1]; incident_dirs [N, S, 3]; incident_areas
    [N, S, 1]; env_radiance: env_direct_light(incident_dirs) evaluated by
    the caller, who shares it with the consistency loss.

    Returns (pbr [N, 12], dict of the intermediate terms).
    """
    if env_radiance is None:
        env_radiance = env_direct_light(incident_dirs)
    local_lights = radiance
    global_lights = torch.clamp(env_radiance, 0.0, 64.0) * visibility
    incident_lights = local_lights + global_lights          # [N, S, 3]

    # n.l per (sample, vertex): [N, S, 4, 1]
    n_d_i = torch.clamp((normals[:, None] * incident_dirs[:, :, None]).sum(
        -1, keepdim=True), min=0)
    f_d = base_color[:, None] / math.pi                     # [N, 1, 12]
    f_s = ggx_specular4(normals, viewdirs, incident_dirs, roughness)
    # [N, S, 4, 1] -> [N, S, 4] tiled x3 = channel-major [N, S, 12]
    f_s = f_s[..., 0].repeat(1, 1, 3)

    def fold(lights):
        t = lights[:, :, None] * incident_areas[:, :, None] * n_d_i
        return t.transpose(2, 3).reshape(t.shape[0], t.shape[1], -1)

    transport = fold(incident_lights)                        # [N, S, 12]
    specular = (f_s * transport).mean(-2)
    pbr = ((f_d + f_s) * transport).mean(-2)
    diffuse_light = transport.mean(-2)

    direct_pbr = ((f_d + f_s) * fold(global_lights)).mean(-2)
    indirect_pbr = ((f_d + f_s) * fold(local_lights)).mean(-2)

    extra = {
        "incident_dirs": incident_dirs,
        "incident_lights": incident_lights,
        "local_incident_lights": local_lights,
        "global_incident_lights": global_lights,
        "incident_visibility": visibility,
        "diffuse_light": diffuse_light,
        "specular": specular,
        "direct": direct_pbr,
        "indirect": indirect_pbr,
    }
    return pbr, extra


# ---------------------------------------------------------------------------
# the training path: pbr and diffuse light only, with a hand-derived backward
# ---------------------------------------------------------------------------

_LO = 1e-6                    # the clamps' lower bound
_FOUR_PI = 4 * math.pi
_INV_PI = 1 / math.pi
_FRES_A, _FRES_B = -5.55473, -6.98316
SHADE_CHUNK_PAIRS = 1 << 20   # (row, sample) pairs of the plain version's
                              # temporaries at a time


def _normalize_backward(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``normalize``'s backward along the last dim: g r - v (g . v) r^3,
    the second term only where the clamp of |v|^2 passes its gradient."""
    sq = (v * v).sum(-1, keepdim=True)
    r = torch.rsqrt(torch.clamp(sq, min=1e-24))
    c = torch.where(sq >= 1e-24, (g * v).sum(-1, keepdim=True) * r * r * r,
                    torch.zeros_like(sq))
    return g * r - v * c


def _inside(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Where ``torch.clamp(x, lo, hi)`` passes its gradient."""
    return (x >= lo) & (x <= hi)


def _row_terms(roughness, normals, viewdirs):
    """The kernels' per-row terms: V [R, 3]; per vertex [R, 4] the flip
    sign(V . normalize(n)), the flipped unit normal [R, 4, 3], the raw and
    clamped N.V, alpha, alpha^2, k and nom1 = NoV (1 - k) + k."""
    v = normalize(viewdirs)
    nn = normalize(normals)
    sg = torch.sign((v[:, None] * nn).sum(-1))
    nf = nn * sg[..., None]
    nov_raw = (nf * v[:, None]).sum(-1)
    nov = torch.clamp(nov_raw, _LO, 1)
    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2 * roughness + 1) * 0.125
    return dict(v=v, sg=sg, nf=nf, nov_raw=nov_raw, nov=nov, alpha=alpha,
                alpha2=alpha2, k=k, nom1=nov * (1 - k) + k)


def _tap_terms(q, normals, incident_dirs):
    """The kernels' per-(row, sample) terms: L and the half vector before
    (u) and after its normalization [R, S, 3], V.H raw and clamped, 2^fmi
    and the Fresnel term [R, S]; per vertex [R, S, 4] N.L of the transport
    (raw normal), GGX's N.L and N.H raw and clamped, nom0, nom2, the
    denominator before (p) and after its clamp, and the specular term."""
    l = normalize(incident_dirs)
    u = (l + q["v"][:, None]) * 0.5
    h = normalize(u)
    voh_raw = (q["v"][:, None] * h).sum(-1)
    voh = torch.clamp(voh_raw, _LO, 1)
    e2 = torch.exp2((_FRES_A * voh + _FRES_B) * voh)
    frac0 = 0.04 + 0.96 * e2
    ndi_raw = (normals[:, None] * incident_dirs[:, :, None]).sum(-1)
    nol_raw = (q["nf"][:, None] * l[:, :, None]).sum(-1)
    noh_raw = (q["nf"][:, None] * h[:, :, None]).sum(-1)
    nol = torch.clamp(nol_raw, _LO, 1)
    noh = torch.clamp(noh_raw, _LO, 1)
    alpha2, k = q["alpha2"][:, None], q["k"][:, None]
    nom0 = noh * noh * (alpha2 - 1) + 1
    nom2 = nol * (1 - k) + k
    p = _FOUR_PI * nom0 * nom0 * q["nom1"][:, None] * nom2
    nom = torch.clamp(p, _LO, _FOUR_PI)
    return dict(l=l, u=u, h=h, voh_raw=voh_raw, voh=voh, e2=e2, frac0=frac0,
                ndi_raw=ndi_raw, nol_raw=nol_raw, noh_raw=noh_raw, nol=nol,
                noh=noh, nom0=nom0, nom2=nom2, p=p, nom=nom,
                fs=frac0[..., None] * alpha2 / nom)


def _light(radiance, env_radiance, visibility, incident_areas):
    """(radiance + clamp(env, 0, 64) * visibility) * area [R, S, 3]."""
    return (radiance + torch.clamp(env_radiance, 0.0, 64.0) * visibility) \
        * incident_areas


def _chunks(n: int, s: int):
    step = max(SHADE_CHUNK_PAIRS // max(s, 1), 1)
    return [slice(r0, r0 + step) for r0 in range(0, n, step)]


def _shade_rows(base_color, roughness, normals, viewdirs, radiance,
                env_radiance, visibility, incident_dirs, incident_areas):
    s = radiance.shape[1]
    q = _row_terms(roughness, normals, viewdirs)
    t = _tap_terms(q, normals, incident_dirs)
    fd = (base_color * _INV_PI).reshape(-1, 3, 4)
    a = _light(radiance, env_radiance, visibility, incident_areas)
    tr = a[..., None] * torch.clamp(t["ndi_raw"], min=0)[:, :, None]
    pbr = ((fd[:, None] + t["fs"][:, :, None]) * tr).sum(1) / s
    return pbr.reshape(-1, 12), (tr.sum(1) / s).reshape(-1, 12)


def shade_train_forward_plain(base_color, roughness, normals, viewdirs,
                              radiance, env_radiance, visibility,
                              incident_dirs, incident_areas):
    """The plain version of ``svgir_shading_forward``: the kernel's
    arithmetic in PyTorch, over chunks of rows, in the inputs' dtype and
    on their device; no autograd.  Shapes as ``shade_train``'s."""
    n, s = radiance.shape[:2]
    ins = (base_color, roughness, normals, viewdirs, radiance, env_radiance,
           visibility, incident_dirs, incident_areas)
    with torch.no_grad():
        outs = [_shade_rows(*(x[c] for x in ins)) for c in _chunks(n, s)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _shade_rows_backward(base_color, roughness, normals, viewdirs, radiance,
                         env_radiance, visibility, incident_dirs,
                         incident_areas, d_pbr, d_dl):
    s = radiance.shape[1]
    q = _row_terms(roughness, normals, viewdirs)
    t = _tap_terms(q, normals, incident_dirs)
    zero = torch.zeros((), dtype=radiance.dtype, device=radiance.device)
    # the mean's cotangents: gp for pbr, and h = gp base / pi + gd, so
    # that d transport = gp (base / pi + fs_v) + gd = h + gp fs_v
    gp = (d_pbr / s).reshape(-1, 3, 4)[:, None]                 # [R,1,3,4]
    h = gp * (base_color * _INV_PI).reshape(-1, 3, 4)[:, None] \
        + (d_dl / s).reshape(-1, 3, 4)[:, None]
    a = _light(radiance, env_radiance, visibility, incident_areas)
    ndi = torch.clamp(t["ndi_raw"], min=0)[:, :, None]          # [R,S,1,4]
    fs = t["fs"]                                                # [R,S,4]

    # the transport: pbr = (base / pi + fs_v) T, diffuse light = T,
    # T = a_c max(N.L_v, 0)
    gt = gp * (a[..., None] * ndi)                              # [R,S,3,4]
    g_fd = gt.sum(1)                                            # [R,3,4]
    gfs = gt.sum(2)                                             # [R,S,4]
    dt = h + gp * fs[:, :, None]
    d_il = (dt * ndi).sum(-1) * incident_areas                  # [R,S,3]
    d_ndi = (dt * a[..., None]).sum(2)                          # [R,S,4]
    d_env = torch.where(_inside(env_radiance, 0.0, 64.0),
                        d_il * visibility, zero)

    # GGX: fs = frac0 alpha2 / nom, nom = clamp(4 pi nom0^2 nom1 nom2)
    alpha2, k = q["alpha2"][:, None], q["k"][:, None]
    nom1 = q["nom1"][:, None]
    dfrac = gfs / t["nom"]
    dfrac0 = (dfrac * alpha2).sum(-1)                           # [R,S]
    c0 = torch.where(_inside(t["p"], _LO, _FOUR_PI),
                     -gfs * fs / t["nom"] * _FOUR_PI, zero)
    nom0, nom2 = t["nom0"], t["nom2"]
    n00 = nom0 * nom0
    dnom0 = c0 * 2 * nom0 * nom1 * nom2
    dnom1 = c0 * n00 * nom2
    dnom2 = c0 * n00 * nom1
    g_alpha2 = (dfrac * t["frac0"][..., None]
                + dnom0 * t["noh"] * t["noh"]).sum(1)           # [R,4]
    g_k = (dnom1 * (1 - q["nov"][:, None])
           + dnom2 * (1 - t["nol"])).sum(1)
    g_nov = (dnom1 * (1 - k)).sum(1)
    dnol = torch.where(_inside(t["nol_raw"], _LO, 1), dnom2 * (1 - k), zero)
    dnoh = torch.where(_inside(t["noh_raw"], _LO, 1),
                       dnom0 * 2 * t["noh"] * (alpha2 - 1), zero)
    g_nf = (dnol[..., None] * t["l"][:, :, None]
            + dnoh[..., None] * t["h"][:, :, None]).sum(1)     # [R,4,3]
    dh = (dnoh[..., None] * q["nf"][:, None]).sum(2)           # [R,S,3]
    g_n = (torch.where(t["ndi_raw"] >= 0, d_ndi, zero)[..., None]
           * incident_dirs[:, :, None]).sum(1)                  # [R,4,3]
    # frac0 = 0.04 + 0.96 * 2^((a VoH + b) VoH); H = normalize((L + V) / 2)
    dvoh = torch.where(_inside(t["voh_raw"], _LO, 1),
                       dfrac0 * 0.96 * t["e2"] * math.log(2)
                       * (2 * _FRES_A * t["voh"] + _FRES_B), zero)
    dv = dvoh[..., None] * t["h"]
    dh = dh + dvoh[..., None] * q["v"][:, None]
    dv = dv + 0.5 * _normalize_backward(t["u"], dh)
    g_v = dv.sum(1)                                             # [R,3]

    # per row: the clamped N.V, the flip, the normalizations, alpha and k
    gnov = torch.where(_inside(q["nov_raw"], _LO, 1), g_nov, zero)
    g_nf = g_nf + gnov[..., None] * q["v"][:, None]
    g_v = g_v + (gnov[..., None] * q["nf"]).sum(1)
    d_normals = _normalize_backward(normals, g_nf * q["sg"][..., None]) + g_n
    galpha = g_alpha2 * 2 * q["alpha"] + g_k * 0.125
    return ((g_fd * _INV_PI).reshape(-1, 12),
            galpha * 2 * roughness + g_k * 0.25, d_normals,
            _normalize_backward(viewdirs, g_v), d_il, d_env)


def shade_train_backward_plain(base_color, roughness, normals, viewdirs,
                               radiance, env_radiance, visibility,
                               incident_dirs, incident_areas, d_pbr,
                               d_diffuse_light):
    """The plain version of ``svgir_shading_backward``: the hand-derived
    backward of the kernel's arithmetic, as autograd takes it through
    ``rendering_equation4`` (clamps pass their gradient inside their bounds,
    both ends inclusive; sign(N.V) passes none), over chunks of rows.
    Returns (d_base_color, d_roughness, d_normals, d_viewdirs, d_radiance,
    d_env_radiance)."""
    n, s = radiance.shape[:2]
    args = (base_color, roughness, normals, viewdirs, radiance, env_radiance,
            visibility, incident_dirs, incident_areas, d_pbr,
            d_diffuse_light)
    with torch.no_grad():
        outs = [_shade_rows_backward(*(x[c] for x in args))
                for c in _chunks(n, s)]
    return tuple(torch.cat(g) for g in zip(*outs))


class _ShadeTrain(torch.autograd.Function):
    """``shade_train``: the kernel pair on CUDA tensors, the plain version
    on CPU tensors.  The backward reads the forward's inputs again and
    saves nothing else."""

    @staticmethod
    def forward(ctx, *ins):
        ctx.save_for_backward(*ins)
        if ins[0].is_cuda:
            return KS.shading_forward(*ins)
        return shade_train_forward_plain(*ins)

    @staticmethod
    def backward(ctx, d_pbr, d_dl):
        ins = ctx.saved_tensors
        fn = KS.shading_backward if ins[0].is_cuda \
            else shade_train_backward_plain
        return (*fn(*ins, d_pbr.contiguous(), d_dl.contiguous()),
                None, None, None)


def shade_train(base_color: torch.Tensor, roughness: torch.Tensor,
                normals: torch.Tensor, viewdirs: torch.Tensor,
                radiance: torch.Tensor, env_radiance: torch.Tensor,
                visibility: torch.Tensor, incident_dirs: torch.Tensor,
                incident_areas: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rendering_equation4``'s ``pbr`` and ``diffuse_light`` [N, 12], for
    the training step, which reads nothing else.  Shapes as
    ``rendering_equation4``'s; ``env_radiance`` is the env evaluated at the
    incident directions.  Gradients reach the first six inputs; the bake's
    visibility, directions and areas take none, and asking for one raises.
    On CUDA tensors (float32) the kernel pair of ``csrc/shading.cu``, else
    the plain version."""
    for name, x in (("visibility", visibility),
                    ("incident_dirs", incident_dirs),
                    ("incident_areas", incident_areas)):
        if x.requires_grad:
            raise ValueError(f"shade_train: {name} takes no gradient")
    return _ShadeTrain.apply(*(x.contiguous() for x in (
        base_color, roughness, normals, viewdirs, radiance, env_radiance,
        visibility, incident_dirs, incident_areas)))
