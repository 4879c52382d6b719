// Golden-vector generator: drives the *reference* implementation's
// freestanding L3 transforms (compiled directly from /root/reference,
// never copied) and dumps known-answer vectors consumed by
// tests/test_goldens.py to prove bit parity of the JAX build.
//
// Build: make -C tests/golden_gen  (writes tests/goldens/goldens.txt)

#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include "m17defines.h"

// Simple deterministic PRNG (xorshift32) so goldens are reproducible.
static uint32_t rng_state = 0xDEADBEEF;
static uint32_t xr(void) {
    uint32_t x = rng_state;
    x ^= x << 13; x ^= x >> 17; x ^= x << 5;
    return rng_state = x;
}

static void dump_u8(FILE *f, const char *name, const uint8_t *v, int n) {
    fprintf(f, "%s %d", name, n);
    for (int i = 0; i < n; i++) fprintf(f, " %u", v[i]);
    fprintf(f, "\n");
}
static void dump_f32(FILE *f, const char *name, const float *v, int n) {
    fprintf(f, "%s %d", name, n);
    for (int i = 0; i < n; i++) fprintf(f, " %.9g", v[i]);
    fprintf(f, "\n");
}
static void dump_u64(FILE *f, const char *name, unsigned long long v) {
    fprintf(f, "%s 1 %llu\n", name, v);
}

int main(void) {
    FILE *f = fopen("../goldens/goldens.txt", "w");
    if (!f) { perror("open"); return 1; }

    m17_init_conv();
    m17_golay_init();
    m17_crc_init();
    m17_init_de_correlate();
    m17_prbs9_init();

    // ---- conv encode (byte input, LSF-sized: 30 bytes -> 488 bits) ----
    uint8_t lsf_bytes[30];
    for (int i = 0; i < 30; i++) lsf_bytes[i] = xr() & 0xFF;
    dump_u8(f, "conv_in_bytes", lsf_bytes, 30);
    uint8_t coded[512];
    int n = m17_conv_encode_8(lsf_bytes, coded, 30);
    dump_u8(f, "conv_out_bits", coded, n);

    // ---- conv encode (bit input, BERT-sized: 201 bits incl 4-bit tail) ----
    uint8_t bert_bits[201];
    for (int i = 0; i < 197; i++) bert_bits[i] = xr() & 1;
    for (int i = 197; i < 201; i++) bert_bits[i] = 0;
    dump_u8(f, "conv1_in_bits", bert_bits, 201);
    uint8_t coded1[512];
    n = m17_conv_encode_1(bert_bits, coded1, 201);
    dump_u8(f, "conv1_out_bits", coded1, n);

    // ---- Viterbi on clean soft bits (+-1) ----
    float soft[512];
    for (int i = 0; i < 488; i++) soft[i] = coded[i] ? 1.0f : -1.0f;
    uint8_t dec[300];
    m17_viterbi_decode(soft, dec, 488);
    dump_u8(f, "viterbi_clean_out", dec, 244);

    // ---- Viterbi on noisy soft bits ----
    for (int i = 0; i < 488; i++) {
        float nz = ((int)(xr() % 2000) - 1000) / 1250.0f;  // U(-0.8, 0.8)
        soft[i] = (coded[i] ? 1.0f : -1.0f) + nz;
    }
    dump_f32(f, "viterbi_noisy_in", soft, 488);
    m17_viterbi_decode(soft, dec, 488);
    dump_u8(f, "viterbi_noisy_out", dec, 244);

    // ---- Viterbi with P2 erasures (stream-frame shaped: 296 bits) ----
    uint8_t sf_bytes[18];
    for (int i = 0; i < 18; i++) sf_bytes[i] = xr() & 0xFF;
    dump_u8(f, "stream_in_bytes", sf_bytes, 18);
    uint8_t sf_coded[300];
    n = m17_conv_encode_8(sf_bytes, sf_coded, 18);           // 296
    uint8_t sf_punc[300];
    int np = m17_punc_p2(sf_coded, sf_punc, n);              // 272
    dump_u8(f, "stream_punc_bits", sf_punc, np);
    float sf_soft_p[300];
    for (int i = 0; i < np; i++) sf_soft_p[i] = sf_punc[i] ? 0.9f : -0.9f;
    float sf_soft[300];
    m17_de_punc_p2(sf_soft_p, sf_soft, 296);
    m17_viterbi_decode(sf_soft, dec, 296);
    dump_u8(f, "stream_viterbi_out", dec, 148);

    // ---- Golay ----
    uint12_t gdata[8];
    uint8_t g24[8 * 3];
    for (int i = 0; i < 8; i++) {
        gdata[i] = xr() & 0xFFF;
        uint24_t w = m17_golay_encode(gdata[i]);
        g24[i * 3] = (w >> 16) & 0xFF; g24[i * 3 + 1] = (w >> 8) & 0xFF; g24[i * 3 + 2] = w & 0xFF;
    }
    fprintf(f, "golay_data 8"); for (int i = 0; i < 8; i++) fprintf(f, " %u", gdata[i]); fprintf(f, "\n");
    dump_u8(f, "golay_words", g24, 24);

    // ---- Puncture / interleave / decorrelate on the LSF coded bits ----
    uint8_t punc[488];
    np = m17_punc_p1(coded, punc, 488);
    dump_u8(f, "p1_punc_bits", punc, np);
    uint8_t il[368];
    m17_interleave(punc, il, 368);
    dump_u8(f, "interleaved_bits", il, 368);
    uint8_t wh[368];
    m17_de_correlate_1(il, wh, 368);
    dump_u8(f, "whitened_bits", wh, 368);

    // Soft deinterleave path
    float sil[368], sde[368];
    for (int i = 0; i < 368; i++) sil[i] = wh[i] ? 1.0f : -1.0f;
    m17_de_correlate_1(sil, sde, 368);
    float sdi[368];
    m17_de_interleave(sde, sdi, 368);
    fprintf(f, "soft_deint_sign 368");
    for (int i = 0; i < 368; i++) fprintf(f, " %d", sdi[i] > 0 ? 1 : 0);
    fprintf(f, "\n");

    // ---- CRC ----
    uint8_t crc_msg[30];
    for (int i = 0; i < 30; i++) crc_msg[i] = xr() & 0xFF;
    dump_u8(f, "crc_msg", crc_msg, 30);
    dump_u64(f, "crc_val", m17_crc_array_encode(crc_msg, 30));

    // ---- Callsign ----
    dump_u64(f, "call_g4guo", m17_encode_call("G4GUO    "));
    dump_u64(f, "call_ab1cde", m17_encode_call("AB1CDE   "));

    // ---- Type field ----
    M17Type t;
    t.p_s = 1; t.dt = 2; t.et = 0; t.est = 0; t.can = 5; t.reserved = 0;
    dump_u64(f, "type_word", m17_pack_type(t));

    // ---- PRBS9 ----
    uint8_t prbs[64];
    m17_prbs9_tx_reset();
    m17_prbs9_tx_load(prbs, 64);
    dump_u8(f, "prbs9_first64", prbs, 64);

    fclose(f);
    printf("goldens written\n");
    return 0;
}
