// Constants of the tower kernels (tower.cuh): Montgomery form with
// R = 2^384 unless noted, as 12 little-endian 32-bit words.
// Generated by `python3 -m lodestar_tpu_torch.gen_tower_consts`; do not edit.
#pragma once

#include <stdint.h>

namespace tw {
namespace consts {

// 1
TW_INL void one(uint32_t w[12]) {
  w[0] = 0x0002fffdu;
  w[1] = 0x76090000u;
  w[2] = 0xc40c0002u;
  w[3] = 0xebf4000bu;
  w[4] = 0x53c758bau;
  w[5] = 0x5f489857u;
  w[6] = 0x70525745u;
  w[7] = 0x77ce5853u;
  w[8] = 0xa256ec6du;
  w[9] = 0x5c071a97u;
  w[10] = 0xfa80e493u;
  w[11] = 0x15f65ec3u;
}

// 3*b' = 12 + 12u, the twist's b3
TW_INL void b3(uint32_t c0[12], uint32_t c1[12]) {
  c0[0] = 0x0027552eu;
  c0[1] = 0x44760000u;
  c0[2] = 0x43480020u;
  c0[3] = 0xdcb8009au;
  c0[4] = 0x4a6e8b59u;
  c0[5] = 0x6f7ee9ceu;
  c0[6] = 0xc0a95bc6u;
  c0[7] = 0xb10330b7u;
  c0[8] = 0xfb1e54b7u;
  c0[9] = 0x6140b1fcu;
  c0[10] = 0x7f0bb4e1u;
  c0[11] = 0x0381be09u;
  c1[0] = 0x0027552eu;
  c1[1] = 0x44760000u;
  c1[2] = 0x43480020u;
  c1[3] = 0xdcb8009au;
  c1[4] = 0x4a6e8b59u;
  c1[5] = 0x6f7ee9ceu;
  c1[6] = 0xc0a95bc6u;
  c1[7] = 0xb10330b7u;
  c1[8] = 0xfb1e54b7u;
  c1[9] = 0x6140b1fcu;
  c1[10] = 0x7f0bb4e1u;
  c1[11] = 0x0381be09u;
}

// the affine G1 generator's x and -y
TW_INL void g1_x(uint32_t w[12]) {
  w[0] = 0xfd530c16u;
  w[1] = 0x5cb38790u;
  w[2] = 0x9976fff5u;
  w[3] = 0x7817fc67u;
  w[4] = 0x143ba1c1u;
  w[5] = 0x154f95c7u;
  w[6] = 0xf3d0e747u;
  w[7] = 0xf0ae6acdu;
  w[8] = 0x21dbf440u;
  w[9] = 0xedce6eccu;
  w[10] = 0x9e0bfb75u;
  w[11] = 0x12017741u;
}

TW_INL void g1_neg_y(uint32_t w[12]) {
  w[0] = 0xf318883au;
  w[1] = 0xff526c2au;
  w[2] = 0x383b0270u;
  w[3] = 0x92899ce4u;
  w[4] = 0x9fa9d055u;
  w[5] = 0x89d7738du;
  w[6] = 0xa344c12au;
  w[7] = 0x12caf35bu;
  w[8] = 0x964b5317u;
  w[9] = 0x3cff1b76u;
  w[10] = 0xe9774430u;
  w[11] = 0x0e44d2edu;
}

// p - 2, a plain integer: the Fermat exponent of the Fp inverse
TW_INL void p_minus_2(uint32_t w[12]) {
  w[0] = 0xffffaaa9u;
  w[1] = 0xb9feffffu;
  w[2] = 0xb153ffffu;
  w[3] = 0x1eabfffeu;
  w[4] = 0xf6b0f624u;
  w[5] = 0x6730d2a0u;
  w[6] = 0xf38512bfu;
  w[7] = 0x64774b84u;
  w[8] = 0x434bacd7u;
  w[9] = 0x4b1ba7b6u;
  w[10] = 0x397fe69au;
  w[11] = 0x1a0111eau;
}

// R^3 mod p, a plain integer: one Montgomery multiply by it turns the
// plain inverse (aR)^-1 of a Montgomery value aR into a^-1 R
TW_INL void r3(uint32_t w[12]) {
  w[0] = 0xd94ca1e0u;
  w[1] = 0xed48ac6bu;
  w[2] = 0x03a7adf8u;
  w[3] = 0x315f831eu;
  w[4] = 0x615e29ddu;
  w[5] = 0x9a53352au;
  w[6] = 0x921e1761u;
  w[7] = 0x34c04e5eu;
  w[8] = 0x65724728u;
  w[9] = 0x2512d435u;
  w[10] = 0x91755d4du;
  w[11] = 0x0aa63460u;
}

// gamma_i^(k) = xi^(i (p^k - 1) / 6), k = 1..3, i = 0..5: the Frobenius
// coefficients of the w-basis (bls/fields.py FROB_GAMMA)
TW_FN void gamma(uint32_t c0[12], uint32_t c1[12], int k, int i) {
  switch (6 * (k - 1) + i) {
    case 0:
      c0[0] = 0x0002fffdu;
      c0[1] = 0x76090000u;
      c0[2] = 0xc40c0002u;
      c0[3] = 0xebf4000bu;
      c0[4] = 0x53c758bau;
      c0[5] = 0x5f489857u;
      c0[6] = 0x70525745u;
      c0[7] = 0x77ce5853u;
      c0[8] = 0xa256ec6du;
      c0[9] = 0x5c071a97u;
      c0[10] = 0xfa80e493u;
      c0[11] = 0x15f65ec3u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 1:
      c0[0] = 0xb319d465u;
      c0[1] = 0x07089552u;
      c0[2] = 0xb50a8313u;
      c0[3] = 0xc6695f92u;
      c0[4] = 0xd117228fu;
      c0[5] = 0x97e83cccu;
      c0[6] = 0xb2dc29eeu;
      c0[7] = 0xa35baecau;
      c0[8] = 0x5daace4du;
      c0[9] = 0x1ce393eau;
      c0[10] = 0xb0fb66ebu;
      c0[11] = 0x08f2220fu;
      c1[0] = 0x4ce5d646u;
      c1[1] = 0xb2f66aadu;
      c1[2] = 0xfc497cecu;
      c1[3] = 0x5842a06bu;
      c1[4] = 0x2599d394u;
      c1[5] = 0xcf4895d4u;
      c1[6] = 0x40a8e8d0u;
      c1[7] = 0xc11b9cbau;
      c1[8] = 0xe5a0de89u;
      c1[9] = 0x2e3813cbu;
      c1[10] = 0x88847fafu;
      c1[11] = 0x110eefdau;
      break;
    case 2:
      c0[0] = 0x00000000u;
      c0[1] = 0x00000000u;
      c0[2] = 0x00000000u;
      c0[3] = 0x00000000u;
      c0[4] = 0x00000000u;
      c0[5] = 0x00000000u;
      c0[6] = 0x00000000u;
      c0[7] = 0x00000000u;
      c0[8] = 0x00000000u;
      c0[9] = 0x00000000u;
      c0[10] = 0x00000000u;
      c0[11] = 0x00000000u;
      c1[0] = 0x8671f071u;
      c1[1] = 0xcd03c9e4u;
      c1[2] = 0x1fcda5d2u;
      c1[3] = 0x5dab2246u;
      c1[4] = 0xd3851b95u;
      c1[5] = 0x587042afu;
      c1[6] = 0x01bacb9eu;
      c1[7] = 0x8eb60ebeu;
      c1[8] = 0x83d050d2u;
      c1[9] = 0x03f97d6eu;
      c1[10] = 0x54638741u;
      c1[11] = 0x18f02065u;
      break;
    case 3:
      c0[0] = 0x5aa30fdau;
      c0[1] = 0x7bcfa7a2u;
      c0[2] = 0x2a927e7cu;
      c0[3] = 0xdc17dec1u;
      c0[4] = 0x6b4ebef1u;
      c0[5] = 0x2f088dd8u;
      c0[6] = 0xda74d4a7u;
      c0[7] = 0xd1ca2087u;
      c0[8] = 0x96cebc1du;
      c0[9] = 0x2da25966u;
      c0[10] = 0xbbfd87d2u;
      c0[11] = 0x0e2b7eedu;
      c1[0] = 0x5aa30fdau;
      c1[1] = 0x7bcfa7a2u;
      c1[2] = 0x2a927e7cu;
      c1[3] = 0xdc17dec1u;
      c1[4] = 0x6b4ebef1u;
      c1[5] = 0x2f088dd8u;
      c1[6] = 0xda74d4a7u;
      c1[7] = 0xd1ca2087u;
      c1[8] = 0x96cebc1du;
      c1[9] = 0x2da25966u;
      c1[10] = 0xbbfd87d2u;
      c1[11] = 0x0e2b7eedu;
      break;
    case 4:
      c0[0] = 0x867545c3u;
      c0[1] = 0x890dc9e4u;
      c0[2] = 0x3285a5d5u;
      c0[3] = 0x2af32253u;
      c0[4] = 0x309b7e2cu;
      c0[5] = 0x50880866u;
      c0[6] = 0x7e881024u;
      c0[7] = 0xa20d1b8cu;
      c0[8] = 0xe2db9068u;
      c0[9] = 0x14e4f04fu;
      c0[10] = 0x1564853au;
      c0[11] = 0x14e56d3fu;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 5:
      c0[0] = 0x0dbce43fu;
      c0[1] = 0x82d83cf5u;
      c0[2] = 0xdf9d018fu;
      c0[3] = 0xa2813e53u;
      c0[4] = 0x3c65e181u;
      c0[5] = 0xc6f0caa5u;
      c0[6] = 0x8d50fe95u;
      c0[7] = 0x7525cf52u;
      c0[8] = 0xf4798a6bu;
      c0[9] = 0x4a85ed50u;
      c0[10] = 0x6cf8eebdu;
      c0[11] = 0x171da0fdu;
      c1[0] = 0xf242c66cu;
      c1[1] = 0x3726c30au;
      c1[2] = 0xd1b6fe70u;
      c1[3] = 0x7c2ac1aau;
      c1[4] = 0xba4b14a2u;
      c1[5] = 0xa04007fbu;
      c1[6] = 0x66341429u;
      c1[7] = 0xef517c32u;
      c1[8] = 0x4ed2226bu;
      c1[9] = 0x0095ba65u;
      c1[10] = 0xcc86f7ddu;
      c1[11] = 0x02e370ecu;
      break;
    case 6:
      c0[0] = 0x0002fffdu;
      c0[1] = 0x76090000u;
      c0[2] = 0xc40c0002u;
      c0[3] = 0xebf4000bu;
      c0[4] = 0x53c758bau;
      c0[5] = 0x5f489857u;
      c0[6] = 0x70525745u;
      c0[7] = 0x77ce5853u;
      c0[8] = 0xa256ec6du;
      c0[9] = 0x5c071a97u;
      c0[10] = 0xfa80e493u;
      c0[11] = 0x15f65ec3u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 7:
      c0[0] = 0x798dba3au;
      c0[1] = 0xecfb361bu;
      c0[2] = 0x91865a2cu;
      c0[3] = 0xc100ddb8u;
      c0[4] = 0x232bda8eu;
      c0[5] = 0x0ec08ff1u;
      c0[6] = 0xf1ca4721u;
      c0[7] = 0xd5c13cc6u;
      c0[8] = 0xbf7b5c04u;
      c0[9] = 0x47222a47u;
      c0[10] = 0xe51c5f59u;
      c0[11] = 0x0110f184u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 8:
      c0[0] = 0x798a64e8u;
      c0[1] = 0x30f1361bu;
      c0[2] = 0x7ece5a2au;
      c0[3] = 0xf3b8ddabu;
      c0[4] = 0xc61577f7u;
      c0[5] = 0x16a8ca3au;
      c0[6] = 0x74fd029bu;
      c0[7] = 0xc26a2ff8u;
      c0[8] = 0x60701c6eu;
      c0[9] = 0x3636b766u;
      c0[10] = 0x241b6160u;
      c0[11] = 0x051ba4abu;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 9:
      c0[0] = 0xfffcaaaeu;
      c0[1] = 0x43f5ffffu;
      c0[2] = 0xed47fffdu;
      c0[3] = 0x32b7fff2u;
      c0[4] = 0xa2e99d69u;
      c0[5] = 0x07e83a49u;
      c0[6] = 0x8332bb7au;
      c0[7] = 0xeca8f331u;
      c0[8] = 0xa0f4c069u;
      c0[9] = 0xef148d1eu;
      c0[10] = 0x3eff0206u;
      c0[11] = 0x040ab326u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 10:
      c0[0] = 0x8671f071u;
      c0[1] = 0xcd03c9e4u;
      c0[2] = 0x1fcda5d2u;
      c0[3] = 0x5dab2246u;
      c0[4] = 0xd3851b95u;
      c0[5] = 0x587042afu;
      c0[6] = 0x01bacb9eu;
      c0[7] = 0x8eb60ebeu;
      c0[8] = 0x83d050d2u;
      c0[9] = 0x03f97d6eu;
      c0[10] = 0x54638741u;
      c0[11] = 0x18f02065u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 11:
      c0[0] = 0x867545c3u;
      c0[1] = 0x890dc9e4u;
      c0[2] = 0x3285a5d5u;
      c0[3] = 0x2af32253u;
      c0[4] = 0x309b7e2cu;
      c0[5] = 0x50880866u;
      c0[6] = 0x7e881024u;
      c0[7] = 0xa20d1b8cu;
      c0[8] = 0xe2db9068u;
      c0[9] = 0x14e4f04fu;
      c0[10] = 0x1564853au;
      c0[11] = 0x14e56d3fu;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 12:
      c0[0] = 0x0002fffdu;
      c0[1] = 0x76090000u;
      c0[2] = 0xc40c0002u;
      c0[3] = 0xebf4000bu;
      c0[4] = 0x53c758bau;
      c0[5] = 0x5f489857u;
      c0[6] = 0x70525745u;
      c0[7] = 0x77ce5853u;
      c0[8] = 0xa256ec6du;
      c0[9] = 0x5c071a97u;
      c0[10] = 0xfa80e493u;
      c0[11] = 0x15f65ec3u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 13:
      c0[0] = 0xa55c9ad1u;
      c0[1] = 0x3e2f585du;
      c0[2] = 0x86c18183u;
      c0[3] = 0x4294213du;
      c0[4] = 0x8b623732u;
      c0[5] = 0x382844c8u;
      c0[6] = 0x19103e18u;
      c0[7] = 0x92ad2afdu;
      c0[8] = 0xac7cf0b9u;
      c0[9] = 0x1d794e4fu;
      c0[10] = 0x7d825ec8u;
      c0[11] = 0x0bd592fcu;
      c1[0] = 0x5aa30fdau;
      c1[1] = 0x7bcfa7a2u;
      c1[2] = 0x2a927e7cu;
      c1[3] = 0xdc17dec1u;
      c1[4] = 0x6b4ebef1u;
      c1[5] = 0x2f088dd8u;
      c1[6] = 0xda74d4a7u;
      c1[7] = 0xd1ca2087u;
      c1[8] = 0x96cebc1du;
      c1[9] = 0x2da25966u;
      c1[10] = 0xbbfd87d2u;
      c1[11] = 0x0e2b7eedu;
      break;
    case 14:
      c0[0] = 0x00000000u;
      c0[1] = 0x00000000u;
      c0[2] = 0x00000000u;
      c0[3] = 0x00000000u;
      c0[4] = 0x00000000u;
      c0[5] = 0x00000000u;
      c0[6] = 0x00000000u;
      c0[7] = 0x00000000u;
      c0[8] = 0x00000000u;
      c0[9] = 0x00000000u;
      c0[10] = 0x00000000u;
      c0[11] = 0x00000000u;
      c1[0] = 0x0002fffdu;
      c1[1] = 0x76090000u;
      c1[2] = 0xc40c0002u;
      c1[3] = 0xebf4000bu;
      c1[4] = 0x53c758bau;
      c1[5] = 0x5f489857u;
      c1[6] = 0x70525745u;
      c1[7] = 0x77ce5853u;
      c1[8] = 0xa256ec6du;
      c1[9] = 0x5c071a97u;
      c1[10] = 0xfa80e493u;
      c1[11] = 0x15f65ec3u;
      break;
    case 15:
      c0[0] = 0xa55c9ad1u;
      c0[1] = 0x3e2f585du;
      c0[2] = 0x86c18183u;
      c0[3] = 0x4294213du;
      c0[4] = 0x8b623732u;
      c0[5] = 0x382844c8u;
      c0[6] = 0x19103e18u;
      c0[7] = 0x92ad2afdu;
      c0[8] = 0xac7cf0b9u;
      c0[9] = 0x1d794e4fu;
      c0[10] = 0x7d825ec8u;
      c0[11] = 0x0bd592fcu;
      c1[0] = 0xa55c9ad1u;
      c1[1] = 0x3e2f585du;
      c1[2] = 0x86c18183u;
      c1[3] = 0x4294213du;
      c1[4] = 0x8b623732u;
      c1[5] = 0x382844c8u;
      c1[6] = 0x19103e18u;
      c1[7] = 0x92ad2afdu;
      c1[8] = 0xac7cf0b9u;
      c1[9] = 0x1d794e4fu;
      c1[10] = 0x7d825ec8u;
      c1[11] = 0x0bd592fcu;
      break;
    case 16:
      c0[0] = 0xfffcaaaeu;
      c0[1] = 0x43f5ffffu;
      c0[2] = 0xed47fffdu;
      c0[3] = 0x32b7fff2u;
      c0[4] = 0xa2e99d69u;
      c0[5] = 0x07e83a49u;
      c0[6] = 0x8332bb7au;
      c0[7] = 0xeca8f331u;
      c0[8] = 0xa0f4c069u;
      c0[9] = 0xef148d1eu;
      c0[10] = 0x3eff0206u;
      c0[11] = 0x040ab326u;
      c1[0] = 0x00000000u;
      c1[1] = 0x00000000u;
      c1[2] = 0x00000000u;
      c1[3] = 0x00000000u;
      c1[4] = 0x00000000u;
      c1[5] = 0x00000000u;
      c1[6] = 0x00000000u;
      c1[7] = 0x00000000u;
      c1[8] = 0x00000000u;
      c1[9] = 0x00000000u;
      c1[10] = 0x00000000u;
      c1[11] = 0x00000000u;
      break;
    case 17:
      c0[0] = 0x5aa30fdau;
      c0[1] = 0x7bcfa7a2u;
      c0[2] = 0x2a927e7cu;
      c0[3] = 0xdc17dec1u;
      c0[4] = 0x6b4ebef1u;
      c0[5] = 0x2f088dd8u;
      c0[6] = 0xda74d4a7u;
      c0[7] = 0xd1ca2087u;
      c0[8] = 0x96cebc1du;
      c0[9] = 0x2da25966u;
      c0[10] = 0xbbfd87d2u;
      c0[11] = 0x0e2b7eedu;
      c1[0] = 0xa55c9ad1u;
      c1[1] = 0x3e2f585du;
      c1[2] = 0x86c18183u;
      c1[3] = 0x4294213du;
      c1[4] = 0x8b623732u;
      c1[5] = 0x382844c8u;
      c1[6] = 0x19103e18u;
      c1[7] = 0x92ad2afdu;
      c1[8] = 0xac7cf0b9u;
      c1[9] = 0x1d794e4fu;
      c1[10] = 0x7d825ec8u;
      c1[11] = 0x0bd592fcu;
      break;
    default:
      for (int j = 0; j < 12; j++) c0[j] = c1[j] = 0;
  }
}

// the same gamma_i^(k) as one table of words, [k - 1][i][c0, c1][word], for
// code that indexes them at run time (tower_warp.cuh)
#define TW_GAMMA_WORDS \
  { \
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0xb319d465u, 0x07089552u, 0xb50a8313u, 0xc6695f92u, 0xd117228fu, 0x97e83cccu, 0xb2dc29eeu, 0xa35baecau, 0x5daace4du, 0x1ce393eau, 0xb0fb66ebu, 0x08f2220fu, \
    0x4ce5d646u, 0xb2f66aadu, 0xfc497cecu, 0x5842a06bu, 0x2599d394u, 0xcf4895d4u, 0x40a8e8d0u, 0xc11b9cbau, 0xe5a0de89u, 0x2e3813cbu, 0x88847fafu, 0x110eefdau, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u, \
    0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu, \
    0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu, \
    0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x0dbce43fu, 0x82d83cf5u, 0xdf9d018fu, 0xa2813e53u, 0x3c65e181u, 0xc6f0caa5u, 0x8d50fe95u, 0x7525cf52u, 0xf4798a6bu, 0x4a85ed50u, 0x6cf8eebdu, 0x171da0fdu, \
    0xf242c66cu, 0x3726c30au, 0xd1b6fe70u, 0x7c2ac1aau, 0xba4b14a2u, 0xa04007fbu, 0x66341429u, 0xef517c32u, 0x4ed2226bu, 0x0095ba65u, 0xcc86f7ddu, 0x02e370ecu, \
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x798dba3au, 0xecfb361bu, 0x91865a2cu, 0xc100ddb8u, 0x232bda8eu, 0x0ec08ff1u, 0xf1ca4721u, 0xd5c13cc6u, 0xbf7b5c04u, 0x47222a47u, 0xe51c5f59u, 0x0110f184u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x798a64e8u, 0x30f1361bu, 0x7ece5a2au, 0xf3b8ddabu, 0xc61577f7u, 0x16a8ca3au, 0x74fd029bu, 0xc26a2ff8u, 0x60701c6eu, 0x3636b766u, 0x241b6160u, 0x051ba4abu, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x8671f071u, 0xcd03c9e4u, 0x1fcda5d2u, 0x5dab2246u, 0xd3851b95u, 0x587042afu, 0x01bacb9eu, 0x8eb60ebeu, 0x83d050d2u, 0x03f97d6eu, 0x54638741u, 0x18f02065u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x867545c3u, 0x890dc9e4u, 0x3285a5d5u, 0x2af32253u, 0x309b7e2cu, 0x50880866u, 0x7e881024u, 0xa20d1b8cu, 0xe2db9068u, 0x14e4f04fu, 0x1564853au, 0x14e56d3fu, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu, \
    0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u, \
    0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu, \
    0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu, \
    0xfffcaaaeu, 0x43f5ffffu, 0xed47fffdu, 0x32b7fff2u, 0xa2e99d69u, 0x07e83a49u, 0x8332bb7au, 0xeca8f331u, 0xa0f4c069u, 0xef148d1eu, 0x3eff0206u, 0x040ab326u, \
    0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, \
    0x5aa30fdau, 0x7bcfa7a2u, 0x2a927e7cu, 0xdc17dec1u, 0x6b4ebef1u, 0x2f088dd8u, 0xda74d4a7u, 0xd1ca2087u, 0x96cebc1du, 0x2da25966u, 0xbbfd87d2u, 0x0e2b7eedu, \
    0xa55c9ad1u, 0x3e2f585du, 0x86c18183u, 0x4294213du, 0x8b623732u, 0x382844c8u, 0x19103e18u, 0x92ad2afdu, 0xac7cf0b9u, 0x1d794e4fu, 0x7d825ec8u, 0x0bd592fcu, \
  }

}  // namespace consts
}  // namespace tw
